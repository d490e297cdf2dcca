"""Helpers of the example parity tests (tests/test_torch_examples*.py).

- :func:`jax_example` loads a script of ``examples/`` under a module name
  of its own (``jax_example_<name>``), so the JAX example and the port's
  ``examples_torch.<name>`` live side by side;
- :class:`Fake` stands for any object a JAX example's ``main`` would
  print or pass on, so a test can run that ``main`` with its expensive
  verbs replaced and record the fits it builds (:class:`Capture`);
- :func:`same_posterior` holds a port fit's posterior at a JAX fit's
  positions against the JAX fit's.
"""

import collections
import importlib
import importlib.util
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
RTOL = 1e-10
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


def jax_example(name):
    """A fresh copy of ``examples/<name>.py`` (its module-level state, a
    seeded generator included, made anew)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name):
    return importlib.import_module(f"examples_torch.{name}")


class Stop(Exception):
    """Raised by a capture once it has what the test needs."""


class Fake:
    """Any result a JAX ``main`` prints or passes on: every attribute,
    call and item is another Fake, and it formats as text."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return Fake()

    def __call__(self, *args, **kwargs):
        return Fake()

    def __getitem__(self, key):
        return Fake()

    def __iter__(self):
        return iter((Fake(), Fake()))

    def __format__(self, spec):
        return "<fake>"


class FakeWalker(Fake):
    """A walker whose verbs do nothing and whose best point reads 0."""

    def __init__(self, n_walkers=1, n_datasets=4):
        super().__init__(n_walkers=n_walkers, age=0)
        self._n = n_datasets

    def most_likely_step(self):
        return 0.0, collections.defaultdict(float)

    def most_likely_params(self):
        return collections.defaultdict(float)

    def acceptance(self):
        return 0.0

    def field_offsets(self):
        return [0.0] * self._n

    def posterior_predictive(self, *args, **kwargs):
        return (Fake(),)


class Capture:
    """Stand-ins for constructors: each call records its arguments, returns
    a :class:`FakeWalker` (or raises :class:`Stop` from the ``stop_at``-th
    call on)."""

    def __init__(self, stop_at=None):
        self.calls, self.stop_at = [], stop_at

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        if self.stop_at is not None and len(self.calls) >= self.stop_at:
            raise Stop
        return FakeWalker(kwargs.get("n_walkers", 1))


def same(got, want, msg="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=1e-13, err_msg=msg)


def same_posterior(tw, jw, msg=""):
    """The port fit's posterior at the JAX fit's positions equals the JAX
    fit's (its state's logprob, the posterior there), at 1e-10."""
    pos = np.asarray(jw.state.position)
    got = tw._eval_batch(torch.tensor(pos, dtype=torch.float64)).numpy()
    want = np.asarray(jw.state.logprob)
    assert np.isfinite(want).all(), msg
    same(got, want, msg)


def same_data(got, want, msg=""):
    """Data from the same seeded stream: bit for bit where numpy made it,
    to the last ulps where a model made it (torch's and XLA's transcendental
    functions round apart)."""
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-14, atol=0.0, err_msg=msg)


def carried(jw, **create):
    """The port's twin of JAX walker ``jw``: its state and whole history."""
    from lisp_mcmc_torch.convert import walker_from_numpy

    tw = walker_from_numpy({k: np.asarray(getattr(jw.state, k)) for k in STATE_KEYS},
                           dtype=torch.float64, device="cpu", **create)
    pos, lp = jw._history()
    tw._hist_positions, tw._hist_logprobs = [np.array(pos)], [np.array(lp)]
    return tw


def short_chunks(monkeypatch, size=20):
    """Fits made with no ``chunk_size`` step in chunks of ``size`` (200 by
    default): a tiny budget would otherwise round up to one whole chunk."""
    from lisp_mcmc_torch.kernel import FitConfig

    init = FitConfig.__init__

    def short(self, *args, **kwargs):
        kwargs.setdefault("chunk_size", size)
        init(self, *args, **kwargs)

    monkeypatch.setattr(FitConfig, "__init__", short)


def short_refits(monkeypatch):
    """Refits (reloo, kfold) whose cold mala phase takes the anneal's
    ``n_steps`` instead of at least 2000 (``diagnostics._run_refit``)."""
    from lisp_mcmc_torch import diagnostics

    def run(fit, n_steps, temperature, burn_fraction):
        fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
        fit.reset()
        fit.sampling_steps(n_steps, kernel="mala")
        fit.burn_steps(int(len(fit) * burn_fraction))

    monkeypatch.setattr(diagnostics, "_run_refit", run)


def cheap_evidence(monkeypatch):
    """A tiny-budget run's evidence verbs: nested sampling's refills take 4
    moves instead of 8 d + 16, and SMC moves its particles one 20-step
    chunk a stage (no ``target_moves`` top-up).  Their stages and rounds
    are set by what the data say, which no step count of an example cuts."""
    import dataclasses

    from lisp_mcmc_torch import nested, smc

    budget = nested._nested_budget
    monkeypatch.setattr(nested, "_nested_budget",
                        lambda n_live, k_batch, n_repeat, d, **kw:
                        budget(n_live, k_batch, 4, d, **kw))
    run = smc.smc_sample

    def short_smc(walker, *args, **kwargs):
        walker.config = dataclasses.replace(walker.config, chunk_size=20)
        return run(walker, *args, **{**kwargs, "target_moves": None})

    monkeypatch.setattr(smc, "smc_sample", short_smc)
