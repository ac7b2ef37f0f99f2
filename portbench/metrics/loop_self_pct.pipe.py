"""loop_self_pct.pipe (%): the share of run_file's batched loop (the
program's ``run_file`` span) that none of its child spans names: the
program's own ``other``."""

from portbench.program_spans import self_pct


def read(rec):
    return self_pct(rec, "run_file")
