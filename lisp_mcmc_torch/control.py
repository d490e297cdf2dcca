"""Cooperative cancellation of a running fit (emergency stop).

Rebuilds ``mfit-walker-estop`` (mcmc-fitting.lisp:860-865, checked every
iteration at 904 and 962): a REPL-settable flag that aborts a running fit.
The fit loop checks the flag between chunks (the device never polls the
host mid-chunk), so cancellation latency is one chunk (~200 steps).
"""

from __future__ import annotations

import contextlib
import signal
import threading

__all__ = ["estop", "request_stop", "clear_stop", "stop_requested", "interruptible"]

_flag = threading.Event()


def request_stop() -> None:
    """Set the emergency stop flag (``(setf mfit-walker-estop t)``)."""
    _flag.set()


def clear_stop() -> None:
    """Clear the flag; fit loops call this on entry (mcmc-fitting.lisp:865)."""
    _flag.clear()


def stop_requested() -> bool:
    """True once an emergency stop was requested and not yet cleared."""
    return _flag.is_set()


estop = request_stop  # reference-flavored alias


@contextlib.contextmanager
def interruptible():
    """Route SIGINT to the estop flag for the duration of a fit.

    First Ctrl-C requests a graceful stop at the next chunk boundary;
    a second Ctrl-C raises KeyboardInterrupt as usual.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    previous = signal.getsignal(signal.SIGINT)

    def handler(signum, frame):
        if stop_requested():
            # Second Ctrl-C: hand control back to the embedding app's
            # handler (restoring it first keeps its contract — including
            # an explicit SIG_IGN — rather than raising over it).
            signal.signal(signal.SIGINT, previous)
            if previous is signal.SIG_IGN:
                return  # the embedding app deliberately ignores SIGINT
            if callable(previous):
                previous(signum, frame)
                return
            raise KeyboardInterrupt  # SIG_DFL / None
        request_stop()

    signal.signal(signal.SIGINT, handler)
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, previous)
