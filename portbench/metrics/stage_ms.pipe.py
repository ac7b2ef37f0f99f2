"""stage_ms.pipe (ms per frame): the program's ``stage`` spans (run_file's
pinned allocation, split and padding of each batch into pinned memory)
over the traced run's frames."""

from portbench.program_spans import per_frame_ms


def read(rec):
    return per_frame_ms(rec, "stage")
