"""Walker sets: batch operations over many independent fits (reference C13).

Port of ``lisp_mcmc_tpu/walker_set.py``.  The reference's only "many
chains" notion is a plain list of walkers advanced one after another
(``walker-set-get`` mcmc-fitting.lisp:1029, ``dir->nv-walkers``
nv-specific.lisp:58-66); this container keeps its verbs.  Stacking
same-shaped datasets into one ensemble (``batched.py``) is not ported
yet, nor is ``plot_param`` (it waits for ``plotting.py``).
"""

from __future__ import annotations

__all__ = ["WalkerSet"]


class WalkerSet(list):
    """A list of :class:`~lisp_mcmc_torch.fit.Walker` with the reference's
    batch verbs."""

    def get(self, verb: str, *args, **kwargs):
        """Apply a query verb to every walker (``walker-set-get``, 1029-1030)."""
        return [getattr(w, verb)(*args, **kwargs) for w in self]

    def get_expression(self, expr: str, take: int | None = 1000):
        """Evaluate a derived-quantity expression per walker
        (``walker-set-get-f``, referenced at nv-specific.lisp:87)."""
        from .expressions import walker_with_expression

        return [walker_with_expression(w, expr, take) for w in self]

    def adaptive_steps(self, n: int | None = None, **kwargs):
        """Advance every fit (the ``mapc walker-adaptive-steps`` driver,
        nv-specific.lisp:60)."""
        for w in self:
            w.adaptive_steps(n, **kwargs)

    def median_params(self, take: int | None = None):
        """``walker-set-get-median-params`` (mcmc-fitting_230522.lisp:797)."""
        return [w.median_params(take) for w in self]

    def delete(self):
        """``walker-set-delete`` (1032-1033)."""
        for w in self:
            w.delete()
        self.clear()
