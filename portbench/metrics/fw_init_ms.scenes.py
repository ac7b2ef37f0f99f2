"""fw_init_ms.scenes (ms a pop): the program's ``fw_init`` spans (the FW
re-init of a pop, ``fw.init_afgs1`` with its AR patterns from
``native/argen.c``) over their count, in the traced window."""

from portbench.switch_spans import per_span_ms


def read(rec):
    return per_span_ms(rec, "fw_init")
