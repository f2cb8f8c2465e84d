"""Point-cloud file IO (OBJ, XYZ, PLY)."""
