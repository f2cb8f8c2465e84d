"""Hand-written CUDA kernels, their build, wrappers and plain versions: the
window kernels K0-K2 (``window.py``), the pass kernels (``passes.py``) and
the exact brute-force kNN (``knn.py``, whose plain version is
``ops/knn.py::knn_plain``)."""
