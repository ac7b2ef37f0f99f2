"""assemble_ms.pipe (ms per frame): the program's ``assemble`` spans
(run_file's crop, depth conversion and concatenation of each output frame
for the writer) over the traced run's frames."""

from portbench.program_spans import per_frame_ms


def read(rec):
    return per_frame_ms(rec, "assemble")
