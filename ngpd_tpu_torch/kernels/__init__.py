"""Hand-written CUDA kernels, their build, wrappers and plain versions: the
window kernels K0-K2 (``window.py``), the pass kernels (``passes.py``),
the hybrid engine's and the dense pipeline's per-point stages
(``hybrid.py``, whose plain versions are ``core/hybrid_stages.py``, and
``dense.py``, whose plain versions it holds beside the wrappers), the
exact brute-force kNN (``knn.py``, whose plain version is
``ops/knn.py::knn_plain``) and the learned models' feature kNN and edge
block (``graph.py``, whose plain versions are
``models/dgcnn.py::feature_knn_plain`` and
``models/edge.py::edge_block_plain``)."""
