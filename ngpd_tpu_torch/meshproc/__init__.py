"""The mesh cascade: mesh container, synthetic shapes, metrics, bucketing,
guided normal filtering, patches, the GCN denoiser, the recipe router, the
patch-archive collector."""
