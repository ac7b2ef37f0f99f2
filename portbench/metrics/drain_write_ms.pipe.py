"""drain_write_ms.pipe (ms per frame): run_file's own drain+write timer
(its verbose line) over the traced run's frames."""

from portbench.readers import runfile_ms


def read(rec):
    return runfile_ms(rec, "drain_write_s")
