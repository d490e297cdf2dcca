"""The port's quantiles (``stats.nth_percentile``, ``median`` and the
functions built on them) against the JAX package's.

Both sides take the same seeded numpy inputs in float64 and must agree to
1e-12: every q of ``nth_percentile`` at odd and even lengths along
``axis=0``, ``-1`` and ``None``; a NaN, which poisons its slice; and
inputs above 2^24 entries (a 2^24 + 8 vector, a (4096, 4097) array under
``axis=None``), where ``torch.quantile`` refuses to run.
"""

import numpy as np
import pytest
import torch

from lisp_mcmc_torch import stats
from lisp_mcmc_tpu import stats as jstats

QS = (0.0, 2.5, 50.0, 84.1, 97.5, 100.0)
DERIVED = ("median", "iqr", "std_from_84th_percentile")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12,
                               atol=1e-12, err_msg=what)


@pytest.mark.parametrize("shape", [(7, 40), (6, 41), (1,), (2,)])
@pytest.mark.parametrize("axis", [0, -1, None])
def test_quantiles_match_jax(shape, axis):
    x = np.random.default_rng(len(shape) * 100 + shape[-1]).standard_t(3, size=shape)
    tx = torch.as_tensor(x)
    for q in QS:
        _close(stats.nth_percentile(tx, q, axis), jstats.nth_percentile(x, q, axis),
               f"nth_percentile q={q} axis={axis}")
    _close(stats.nth_percentile(tx, np.array([10.0, 90.0]), axis),
           jstats.nth_percentile(x, np.array([10.0, 90.0]), axis), "two qs")
    for name in DERIVED:
        _close(getattr(stats, name)(tx, axis), getattr(jstats, name)(x, axis),
               f"stats.{name} axis={axis}")
    for a, b in zip(stats.credible_interval_95(tx, axis),
                    jstats.credible_interval_95(x, axis)):
        _close(a, b, f"credible_interval_95 axis={axis}")


def test_quantiles_keep_dtype_and_device():
    x = torch.linspace(-1.0, 1.0, 9, dtype=torch.float32)
    for got in (stats.median(x), stats.nth_percentile(x, 30.0),
                *stats.credible_interval_95(x)):
        assert got.dtype == torch.float32 and got.device == x.device
    assert stats.median([1, 2, 3, 4]).dtype == torch.float64


@pytest.mark.parametrize("axis", [0, -1, None])
def test_nan_poisons_its_slice(axis):
    x = np.random.default_rng(3).normal(size=(5, 9))
    x[2, 4] = np.nan
    tx = torch.as_tensor(x)
    for q in QS:
        got = stats.nth_percentile(tx, q, axis).numpy()
        want = np.asarray(jstats.nth_percentile(x, q, axis))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any()
        _close(got, want, f"nth_percentile with a NaN, q={q} axis={axis}")
    for name in DERIVED:
        _close(getattr(stats, name)(tx, axis), getattr(jstats, name)(x, axis),
               f"stats.{name} with a NaN, axis={axis}")


@pytest.mark.parametrize("shape,axis", [((2**24 + 8,), -1), ((4096, 4097), None)])
def test_quantiles_above_2_pow_24(shape, axis):
    """Above torch.quantile's limit of 2^24 entries in the reduced axis."""
    x = np.random.default_rng(7).normal(size=shape)
    tx = torch.as_tensor(x)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(tx, 0.5, dim=None if axis is None else axis)
    qs = np.array([2.5, 84.1])
    _close(stats.nth_percentile(tx, qs, axis), jstats.nth_percentile(x, qs, axis),
           f"nth_percentile q={qs} on {shape}")
    _close(stats.median(tx, axis), jstats.median(x, axis), f"median on {shape}")
