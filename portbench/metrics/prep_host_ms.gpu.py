"""prep_host_ms.gpu (ms per frame): the program's ``grain.prep`` spans
(the host time of the step's lattice and words: the launches of the
lattice prep) over the traced run's frames, in ``run_device``."""

from portbench.program_spans import per_frame_ms


def read(rec):
    return per_frame_ms(rec, "grain.prep")
