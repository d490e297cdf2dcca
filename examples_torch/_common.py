"""Shared example plumbing: device knob + phase progress markers.

The PyTorch counterpart of ``examples/_common.py``.  Every example
resolves its device with :func:`setup_device` and passes it to every
constructor, and wraps its major steps in :class:`phase` so a run is
visibly alive.

Device knob: ``LISP_MCMC_PLATFORM=cpu python examples_torch/<name>.py``
runs on the CPU.  Unset (or empty), the examples run on the GPU and
raise where there is none (``lisp_mcmc_torch.resolve_device``); any
other value raises.  Nothing carries on on the CPU because it found no
card.
"""

import os
import time

from lisp_mcmc_torch.device import resolve_device


def setup_device():
    """The device the examples run on, from ``LISP_MCMC_PLATFORM``."""
    plat = os.environ.get("LISP_MCMC_PLATFORM")
    if not plat:
        return resolve_device(None)
    if plat == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"LISP_MCMC_PLATFORM={plat!r}: set it to 'cpu', or leave it "
                     "unset to run on the GPU")


_T0 = time.time()


class phase:
    """``with phase("anneal"): ...`` prints timestamped start/done
    lines so long-running examples are visibly alive."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        print(f"[{time.time() - _T0:7.1f}s] >> {self.label}", flush=True)
        self._t = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "done" if exc_type is None else "FAILED"
        print(f"[{time.time() - _T0:7.1f}s] << {self.label} {status} "
              f"({time.time() - self._t:.1f}s)", flush=True)
        return False
