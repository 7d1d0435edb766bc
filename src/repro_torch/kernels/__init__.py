"""Hand-written CUDA kernels of the port (``csrc/``), their Python
wrappers and plain torch versions (``ref.py``), and the dispatch
(``ops.py``)."""
