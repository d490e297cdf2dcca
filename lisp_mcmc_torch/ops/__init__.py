"""Device operations: the three hand-written kernels and plain tensor ops.

``loglik_kernel`` (fused posterior), ``chunk_kernel`` (whole-chunk rwm
stepper) and ``microbench`` (the roofline's per-op ceiling probe) wrap
the CUDA sources in ``../csrc``; ``linalg`` and ``reductions`` are plain
PyTorch.
"""
