"""Hand-written CUDA kernels (``csrc/``) for the O(mn) sweeps, their plain
PyTorch versions, and the dispatch seam (:mod:`.ops`)."""
