"""read_stage_ms.pipe (ms per frame): run_file's own read+stage timer
(its verbose line) over the traced run's frames."""

from portbench.readers import runfile_ms


def read(rec):
    return runfile_ms(rec, "read_stage_s")
