"""File IO: point clouds (OBJ, XYZ, PLY), mesh sampling, ``.mat`` patches and
``.h5`` path lists."""
