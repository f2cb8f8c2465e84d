"""Per-point primitives, Morton order, nearest neighbours and metrics."""
