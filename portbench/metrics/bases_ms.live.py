"""bases_ms.live (ms per frame): mean host time of GrainPipeline.frame_bases
(one call per frame), from the harness's span around each call."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "frame_bases")
