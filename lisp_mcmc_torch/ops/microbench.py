"""Per-op issue-rate probe: the kernel behind the roofline's ceilings.

Port of the Pallas kernel that ``benchmarks/roofline.py:microbench_ceilings``
builds.  The CUDA kernel (``csrc/microbench.cu``) runs one thread per
element of ``x``: ``P = 4`` independent chains start at ``x[i] + j*1e-6``
(``j = 0..3``), each outer iteration applies the op ``U`` times to every
chain (:data:`UNROLL`: 8 as in the JAX probe, 32 for fma so the loop's own
instructions stay out of its rate), and after ``K`` iterations ``out[i]``
is the sum of the chains.  ``lisp_mcmc_torch.roofline`` times two values
of ``K`` and divides the work difference by the time difference, so the
launch overhead cancels and what is left is the op's issue rate.

Besides the JAX probe's five ops there is ``add`` (``x + 1e-6``): the div,
exp and log probes each apply one add or multiply besides their op, and
the roofline takes the add probe's time out of theirs.

:func:`chain_probe` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs :func:`chain_probe_plain`, the
same chains in plain PyTorch, which is also what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_launch, load_library
from .loglik_kernel import op_census

__all__ = ["CHAINS", "UNROLL", "OPS", "FLOPS_PER_OP", "chain_probe",
           "chain_probe_plain", "probe_census", "sm_clock_mhz"]

CHAINS = 4   # P, independent chains per element
# op name -> its id in csrc/microbench.cu (OP_*)
OPS = {"fma": 0, "div": 1, "cos": 2, "exp": 3, "log": 4, "add": 5}
# U, op applications per chain per outer iteration (csrc/microbench.cu)
UNROLL = {"fma": 32, "div": 8, "cos": 8, "exp": 8, "log": 8, "add": 8}
# work one application counts for: an FMA is 2 flops, the others 1 op
FLOPS_PER_OP = {"fma": 2, "div": 1, "cos": 1, "exp": 1, "log": 1, "add": 1}
# each application by op-census class (loglik_kernel.OP_CLASSES)
_OP_CENSUS = {"fma": {"flops": 2}, "div": {"div": 1, "flops": 1},
              "cos": {"cos": 1}, "exp": {"exp": 1, "flops": 1},
              "log": {"log": 1, "flops": 1}, "add": {"flops": 1}}

# The kernel's float32 FFMA rounds x * a + b once.  For float32 x in
# [0.5, 4] the product and the sum are exact in float64, so computing there
# and rounding to float32 gives the same single rounding.
_A32, _B32 = float(np.float32(1.0000001)), float(np.float32(1e-7))


def _fma(x):
    if x.dtype == torch.float32:
        return (x.double() * _A32 + _B32).float()
    return x * 1.0000001 + 1e-7


# The ops of benchmarks/roofline.py:100-104 and the add, in plain PyTorch.
# A Python float operand takes the tensor's dtype, as the kernel's T(...)
# constants do.  The division goes through a 0-d tensor: ``1.0001 / t``
# would be computed as ``t.reciprocal() * 1.0001``, two roundings where the
# kernel has one.
_PLAIN_OPS = {
    "fma": _fma,
    "div": lambda x: x.new_tensor(1.0001) / (x + 1e-6),
    "cos": torch.cos,
    "exp": lambda x: torch.exp(x * 1e-6),
    "log": lambda x: torch.log(x + 1.0),
    "add": lambda x: x + 1e-6,
}


def _check(x, op: str, K: int) -> None:
    if op not in OPS:
        raise ValueError(f"chain_probe: unknown op {op!r}; ops: {sorted(OPS)}")
    if int(K) != K or K < 0:
        raise ValueError(f"chain_probe: K must be an integer >= 0, got {K!r}")
    if x.ndim != 1 or x.numel() < 1:
        raise ValueError(f"chain_probe: x must be a non-empty 1-D tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"chain_probe: no kernel for {x.dtype}")


def chain_probe_plain(x, op: str, K: int):
    """The probe's chains in plain PyTorch (any device), op for op the
    kernel's arithmetic.  In float64 the kernel contracts the fma op into
    one DFMA, one rounding where this version has two."""
    _check(x, op, K)
    f = _PLAIN_OPS[op]
    xs = [x + j * 1e-6 for j in range(CHAINS)]
    for _ in range(int(K)):
        for _ in range(UNROLL[op]):
            xs = [f(c) for c in xs]
    out = xs[0]
    for c in xs[1:]:
        out = out + c
    return out


def probe_census(op: str) -> dict:
    """Operations of one application of ``op`` in the probe, as an op
    census (``loglik_kernel.fused_census``'s form) whose one point is one
    application: a probe of ``K`` iterations over ``n`` elements is
    ``census_totals(probe_census(op), n, K * UNROLL[op] * CHAINS)``."""
    return op_census(per_point=_OP_CENSUS[op])


_PROBE_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _launch_probe(x, op: str, K: int, clock):
    if not x.is_contiguous():
        raise ValueError("chain_probe: x must be contiguous")
    if clock is not None and not (clock.dtype == torch.int64 and clock.numel() == 2
                                  and clock.device == x.device):
        raise ValueError("chain_probe: clock must be two int64 on x's device")
    lib = load_library("microbench")
    fn = lib.lmt_chain_probe
    fn.argtypes, fn.restype = _PROBE_ARGTYPES, ctypes.c_int
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(0 if x.dtype == torch.float32 else 1, OPS[op], x.data_ptr(),
              out.data_ptr(), x.numel(), int(K),
              None if clock is None else clock.data_ptr(), stream)
    check_launch(lib, code, "chain_probe")
    chain_probe.launches += 1
    return out


def chain_probe(x, op: str, K: int, clock=None):
    """``out[i]``: the sum of ``CHAINS`` chains from ``x[i]``, each after
    ``K * UNROLL[op]`` applications of ``op``.  The CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.

    ``clock``, for the kernel only: two int64 on the device, into which
    the launch writes the SM cycles and nanoseconds of its first thread.
    """
    _check(x, op, K)
    if x.device.type == "cpu":
        if clock is not None:
            raise ValueError("chain_probe: clock needs the CUDA kernel")
        return chain_probe_plain(x, op, K)
    return _launch_probe(x, op, K, clock)


chain_probe.launches = 0  # kernel launches, for proof that a path used it


def sm_clock_mhz(x, op: str, K: int) -> float:
    """The SM clock (MHz) during one launch of the probe on CUDA ``x``:
    cycles over nanoseconds of its first thread, which runs for the whole
    of the first wave of blocks."""
    clock = torch.zeros(2, dtype=torch.int64, device=x.device)
    chain_probe(x, op, K, clock=clock)
    cycles, ns = clock.tolist()
    return 1e3 * cycles / ns
