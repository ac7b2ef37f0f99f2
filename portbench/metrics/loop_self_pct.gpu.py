"""loop_self_pct.gpu (%): the share of run_device's frame loop (the
program's ``run_file`` span, the root whoever calls) that none of its
child spans names: the program's own ``other``."""

from portbench.program_spans import self_pct


def read(rec):
    return self_pct(rec, "run_file")
