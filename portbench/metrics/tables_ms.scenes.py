"""tables_ms.scenes (ms a build): the program's ``tables`` spans (the
device tables of a new config, built and uploaded by ``_tables``) over
their count, in the traced window."""

from portbench.switch_spans import per_span_ms


def read(rec):
    return per_span_ms(rec, "tables")
