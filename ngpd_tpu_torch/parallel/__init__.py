from .mesh import make_mesh, shard_points  # noqa: F401
from .sharded import (  # noqa: F401
    chamfer_distance_sharded,
    denoise_sharded,
    knn_sharded,
)
from .fused_sharded import fused_denoise_sharded  # noqa: F401
