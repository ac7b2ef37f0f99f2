"""bases_ms.gpu (ms per frame): mean host time of GrainPipeline.frame_bases
(one call per frame) in ``run_device``, from the harness's span around
each call."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "frame_bases")
