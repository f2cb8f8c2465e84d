"""adjacency_ms.mesh: host milliseconds a mesh of the numpy adjacency
builds, the spans ``ngpd.mesh.adjacency`` (as many as the mesh's
adjacency is built), where the cascade's span ``ngpd.mesh`` ran once a
mesh; 0 where no build ran, in the traced slice."""

from benchmark import spans


def read(rec):
    return spans.part_per_job(rec, "host_ms", "ngpd.mesh.adjacency", "ngpd.mesh")
