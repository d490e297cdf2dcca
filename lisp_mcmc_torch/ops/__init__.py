"""Device operations: the two hand-written kernels and plain tensor ops.

``loglik_kernel`` (fused posterior) and ``chunk_kernel`` (whole-chunk rwm
stepper) wrap the CUDA sources in ``../csrc``; ``linalg`` and
``reductions`` are plain PyTorch.
"""
