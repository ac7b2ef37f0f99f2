"""cfg_read_ms.scenes (ms a pop): the program's ``cfg_read`` spans (a
pop's read, check, chroma adjustment and gain of its cfg file in
``pop_cfg``) over their count, in the traced window."""

from portbench.switch_spans import per_span_ms


def read(rec):
    return per_span_ms(rec, "cfg_read")
