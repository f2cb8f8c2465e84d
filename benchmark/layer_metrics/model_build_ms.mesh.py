"""model_build_ms.mesh: host milliseconds a mesh of the cascade's model
build in each call (the later passes' model from its state dict, and the
models' move to the card), the span ``ngpd.mesh.model_build``, where the
cascade's span ``ngpd.mesh`` ran once a mesh; 0 where it did not run, in
the traced slice."""

from benchmark import spans


def read(rec):
    return spans.part_per_job(rec, "host_ms", "ngpd.mesh.model_build", "ngpd.mesh")
