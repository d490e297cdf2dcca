"""Variational inference: ADVI, RealNVP flow VI, NeuTra and flow checkpoints.

Port of ``lisp_mcmc_tpu/variational.py``.  A Gaussian (``advi``) or a
RealNVP normalizing flow (``flow_advi``) is fitted to the posterior by
stochastic gradient ascent on the ELBO in an unconstrained z-space: with a
resolvable prior spec, ``theta = F^-1(sigmoid(z))`` through the declared
prior's inverse CDF (q's support is the prior's, and ``elbo`` / ``log_z``
follow the shared evidence convention); without one, the ensemble-whitened
identity ``theta = scales * z``.  ``log_z`` is the importance-sampled
evidence under the fitted q with a Pareto-k tail diagnostic.

How the work maps onto the GPU:

- the optimizer loop is a Python loop of steps; each step draws the
  reparameterized eps, evaluates the ELBO through the plain posterior and
  the z-map's log-Jacobian (the map's diagonal derivative for componentwise
  maps, the ``slogdet`` of its Jacobian for an ``MVGaussian``, both by
  reverse mode with ``create_graph``), and differentiates it by autograd,
  as the gradient samplers do;
- the q parameters live in one flat ``(S, P)`` buffer (S = 1, or one row a
  dataset) with views for the leaves, so clipping and Adam are a handful
  of launches a step whatever the number of leaves; on CUDA the whole step
  is captured once in a CUDA graph and replayed;
- the value-only evaluation draws of ``advi`` / ``flow_advi`` on a single
  fit go through ``Walker._batched_posterior()``: kernel 1 on CUDA when
  the fit is inside its coverage, the plain posterior otherwise.

The optimizer reproduces the JAX package's ``optax.chain(
clip_by_global_norm(10), adam(cosine_decay_schedule(lr, n_steps,
alpha)))`` operation for operation (:class:`_ClippedAdam`).  Every Gaussian
draw goes through the module-level :func:`_draws` hook, a
``torch.Generator`` on the fit's device seeded from ``seed``; the parity
tests replace it with the JAX package's own draws.  The streams therefore
differ from the JAX package's by design (``FlowVIResult.sample(n, seed)``
included); flow checkpoints (``.npz``) are one format for both packages.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from .parallel.mesh import refuse_multi_process

__all__ = ["VIResult", "FlowVIResult", "NeutraResult", "advi",
           "flow_advi", "advi_per_dataset", "flow_advi_per_dataset",
           "load_flow"]

_LOG_2PI = math.log(2.0 * math.pi)
_FLOOR = -1e12                 # a non-finite z-space log posterior reads as this
_CLIP_NORM = 10.0
_LAYER_LEAVES = ("w1", "b1", "w2", "b2", "w3", "b3")
_GRAPH_WARMUP = 3              # eager optimizer steps before the CUDA graph


def _draws(generator, shape, dtype, device):
    """Standard normals of ``shape``: every Gaussian draw of this module
    (the ELBO's eps each step, the evaluation draws, ``sample``, NeuTra's
    start) comes from here."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _logmeanexp(x: np.ndarray) -> float:
    m = float(np.max(x))
    if not np.isfinite(m):
        return m
    return m + math.log(float(np.mean(np.exp(x - m))))


def _pareto_k(lw: np.ndarray) -> float:
    """PSIS-style tail shape of log importance weights (JAX
    ``variational._pareto_k``): the generalized Pareto fitted to the
    largest ``min(n/5, 3 sqrt(n))`` weights.  k < 0.7: the IS evidence is
    trustworthy.  inf when every draw hit the non-finite floor; 0 when the
    weights are near uniform (relative ESS > 95 %)."""
    from .diagnostics import _gpd_fit

    lw = np.asarray(lw, np.float64)
    lw = lw[np.isfinite(lw)]
    n = lw.size
    if n < 25:
        return float("nan")
    if np.all(lw < -1e10):
        return float("inf")
    wn = np.exp(lw - lw.max())
    r_eff = float(np.sum(wn) ** 2 / (n * np.sum(wn * wn)))
    if r_eff > 0.95:
        return 0.0
    w = np.exp(lw - lw.max())
    w.sort()
    m = int(min(0.2 * n, 3.0 * math.sqrt(n)))
    cutoff = w[-m - 1]
    excess = w[-m:] - cutoff
    k, _ = _gpd_fit(np.sort(excess))
    return float(k)


def _evidence(lw: np.ndarray, spec, log_v: float):
    """``(elbo, log_z, log_z_error)`` of one fit's evaluation weights;
    Nones without a spec.  The error is the standard error over 8 batches."""
    if spec is None:
        return None, None, None
    elbo = float(np.mean(lw)) - log_v
    log_z = _logmeanexp(lw) - log_v
    per = lw.size // 8
    err = None
    if per >= 2:
        batched = [_logmeanexp(lw[i * per:(i + 1) * per]) for i in range(8)]
        err = float(np.std(batched) / math.sqrt(8))
    return elbo, log_z, err


def _moments(theta: np.ndarray, keys):
    mean_vec = theta.mean(axis=0)
    cov = np.atleast_2d(np.cov(theta.T))
    mean = {k: float(mean_vec[i]) for i, k in enumerate(keys)}
    sd = {k: float(math.sqrt(max(cov[i, i], 0.0))) for i, k in enumerate(keys)}
    return mean, sd, cov


# ------------------------------------------------------------- optimizer


class _ClippedAdam:
    """``optax.chain(clip_by_global_norm(10), adam(cosine_decay_schedule(lr,
    n_steps, alpha)))`` on the rows of a flat ``(S, P)`` parameter buffer,
    each row its own problem (its own norm and moments), in optax's order:
    non-finite gradient entries zeroed, the global norm of the row (every
    leaf, zeros included) clipped to 10 as ``(g / norm) * 10``, the
    moments, the bias corrections at ``count + 1``, ``m / (sqrt(v) + eps)``,
    then the rate ``lr ((1 - alpha) (1 + cos(pi min(count, T) / T)) / 2 +
    alpha)`` at the count before the step.  The moments update in place
    and a step's scalars come as a tensor row of :meth:`schedule`, so a
    step can be captured in a CUDA graph."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, like: torch.Tensor, learning_rate: float, n_steps: int,
                 alpha: float):
        self.m = torch.zeros_like(like)
        self.v = torch.zeros_like(like)
        self.lr = float(learning_rate)
        self.decay_steps = float(max(int(n_steps), 1))
        self.alpha = float(alpha)

    def schedule(self, n: int) -> np.ndarray:
        """``(n, 3)``: each step's ``-rate``, ``1 - b1^(count + 1)`` and
        ``1 - b2^(count + 1)``, in float64 on the host."""
        out = np.empty((n, 3))
        for count in range(n):
            c = min(float(count), self.decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / self.decay_steps))
            out[count] = (-(self.lr * ((1.0 - self.alpha) * cosine + self.alpha)),
                          1.0 - self.b1 ** (count + 1), 1.0 - self.b2 ** (count + 1))
        return out

    @torch.no_grad()
    def step(self, flat: torch.Tensor, g: torch.Tensor, row: torch.Tensor) -> None:
        """One update of ``flat`` in place from the gradient ``g``; ``row`` is
        this step's row of :meth:`schedule`."""
        g = torch.where(torch.isfinite(g), g, 0.0)
        norm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        small = norm < _CLIP_NORM
        g = torch.where(small, g, g / torch.where(small, 1.0, norm) * _CLIP_NORM)
        self.m.mul_(self.b1).add_((1.0 - self.b1) * g)
        self.v.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
        m_hat = self.m / row[1]
        v_hat = self.v / row[2]
        flat.add_(row[0] * (m_hat / (torch.sqrt(v_hat) + self.eps)))


def _layout(entries):
    """``[(name, shape, offset)]`` of a flat layout of ``(name, shape)`` leaves."""
    out, off = [], 0
    for name, shape in entries:
        out.append((name, tuple(shape), off))
        off += int(np.prod(shape))
    return out


def _views(flat: torch.Tensor, layout, batched: bool) -> dict:
    """The leaves of a flat ``(S, P)`` buffer: ``(S, *shape)`` views when
    ``batched``, else row 0's ``shape`` views.  Flow leaves named
    ``layers.k.name`` nest into ``{"layers": [{name: ...}, ...]}``."""
    out: dict = {}
    for name, shape, off in layout:
        n = int(np.prod(shape))
        v = (flat[:, off:off + n].reshape(flat.shape[0], *shape) if batched
             else flat[0, off:off + n].reshape(shape))
        if name.startswith("layers."):
            _, k, leaf = name.split(".")
            layers = out.setdefault("layers", [])
            while len(layers) <= int(k):
                layers.append({})
            layers[int(k)][leaf] = v
        else:
            out[name] = v
    return out


def _flat_from(values: dict, layout, S: int, dtype, device) -> torch.Tensor:
    """A ``(S, P)`` buffer from numpy leaves with a leading S axis."""
    cols = []
    for name, shape, _ in layout:
        if name.startswith("layers."):
            _, k, leaf = name.split(".")
            a = values["layers"][int(k)][leaf]
        else:
            a = values[name]
        cols.append(np.asarray(a, np.float64).reshape(S, -1))
    return torch.as_tensor(np.concatenate(cols, axis=1), dtype=dtype, device=device)


def _run_optimizer(flat0, layout, batched: bool, loss_fn, eps_shape, n_steps: int,
                   learning_rate: float, alpha: float, avg_frac: float, seed: int):
    """The shared Adam loop: ``loss_fn(views, eps) -> (S,)`` negative ELBOs
    (one per row), eps from :func:`_draws` each step.  Returns the Polyak
    average of the iterates from ``int(avg_frac n_steps)`` on (the JAX
    package's tail average) as a flat buffer, and the ``(n_steps, S)`` ELBO
    trace at the pre-update parameters.

    On CUDA a step (the ELBO, its gradient and the update) is captured in a
    CUDA graph after ``_GRAPH_WARMUP`` eager steps on a side stream and
    replayed from then on: a step dispatches hundreds of small kernels, and
    the host's dispatch, not the device, paces it otherwise.  Each step's
    draws and schedule row are copied into the graph's static inputs."""
    dtype, device = flat0.dtype, flat0.device
    flat = flat0.clone().requires_grad_(True)
    opt = _ClippedAdam(flat0, learning_rate, n_steps, alpha)
    sched = torch.as_tensor(opt.schedule(n_steps), dtype=dtype, device=device)
    row = torch.empty(3, dtype=dtype, device=device)
    eps = torch.empty(tuple(eps_shape), dtype=dtype, device=device)
    loss_out = torch.empty(flat0.shape[0], dtype=dtype, device=device)
    acc = torch.zeros_like(flat0)
    trace = torch.empty((n_steps, flat0.shape[0]), dtype=dtype, device=device)
    avg_from = int(avg_frac * n_steps)
    gen = _generator(device, seed)

    def step():
        loss = loss_fn(_views(flat, layout, batched), eps).reshape(-1)
        (g,) = torch.autograd.grad(loss.sum(), flat)
        opt.step(flat, g, row)
        loss_out.copy_(loss.detach())

    on_cuda = device.type == "cuda"
    graph, side = None, torch.cuda.Stream(device) if on_cuda else None
    for i in range(n_steps):
        eps.copy_(_draws(gen, eps_shape, dtype, device))
        row.copy_(sched[i])
        if graph is not None:
            graph.replay()
        elif on_cuda and i >= _GRAPH_WARMUP:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            graph.replay()
        elif on_cuda:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
        else:
            step()
        with torch.no_grad():
            trace[i].copy_(loss_out)
            if i >= avg_from:
                acc += flat
    return acc / max(n_steps - avg_from, 1), -_host(trace).astype(np.float64)


# ------------------------------------------------------------ the z-space


@dataclasses.dataclass
class _ZSpace:
    """The unconstrained space of one fit (or of S fits):
    ``theta_of_z`` (``(..., d) -> (..., d)``), ``map_logdet(z) -> (theta,
    log|det dtheta/dz|)``, the ensemble's z coordinates ``z0`` (numpy), the
    box volume ``log_v`` of the spec's Uniform components and the whitening
    ``scales`` (None with a spec)."""

    keys: list
    d: int
    spec: object
    theta_of_z: object
    map_logdet: object
    z0: np.ndarray
    log_v: float
    scales: object


def _z_space(keys, spec, pos: np.ndarray, dtype, device, scales=None,
             batched: bool = False) -> _ZSpace:
    """The z -> theta map (JAX ``_z_space_setup``, variational.py:214-301).

    ``pos``: the ensemble ``(W, d)``, or ``(S, B, d)`` S blocks ``batched``.
    With a spec the map is the spec's inverse CDF behind a sigmoid, the
    ensemble's u clipped to 1e-6 (float32) or 1e-9 off the faces; without
    one the whitened identity by each block's ``_nonzero_scales`` of the
    median |position| (or the given frozen ``scales``).  The log-Jacobian
    of a componentwise map (a ``PriorSpec`` or none) is the log of the
    map's diagonal derivative (JAX: one ``jvp`` with a ones tangent); an
    ``MVGaussian``'s the ``slogdet`` of its Jacobian (JAX: ``jacfwd``).
    Both are reverse-mode derivatives kept differentiable for the ELBO."""
    from .fit import _nonzero_scales
    from .priors import PriorSpec, Uniform

    d = len(keys)
    if spec is not None:
        def theta_of_z(z):
            return spec.transform(torch.sigmoid(z), keys)

        u_eps = 1e-6 if dtype == torch.float32 else 1e-9
        u0 = np.clip(_host(spec.inverse(pos.reshape(-1, d), keys)).astype(np.float64),
                     u_eps, 1.0 - u_eps).reshape(pos.shape)
        z0 = np.log(u0) - np.log1p(-u0)
        log_v = float(sum(math.log(spec[k].high - spec[k].low)
                          for k in keys if isinstance(spec[k], Uniform)))
    else:
        if scales is None:
            if not batched:
                scales = _nonzero_scales(np.median(np.abs(pos), axis=0))
            else:
                scales = np.stack([_nonzero_scales(np.median(np.abs(p), axis=0))
                                   for p in pos])
        scales = np.asarray(scales, np.float64)
        s_t = torch.as_tensor(scales[:, None, :] if batched else scales,
                              dtype=dtype, device=device)

        def theta_of_z(z):
            return s_t * z

        z0 = pos / (scales[:, None, :] if batched else scales)
        log_v = 0.0

    componentwise = spec is None or isinstance(spec, PriorSpec)

    def map_logdet(z):
        # Reverse mode, differentiable when z is (create_graph): the map's
        # derivative of the summed outputs is its Jacobian's diagonal for a
        # componentwise map; an MVGaussian's Jacobian takes one pass a row.
        need_graph = z.requires_grad
        with torch.enable_grad():
            zz = z if need_graph else z.detach().requires_grad_(True)
            theta = theta_of_z(zz)
            if componentwise:
                (dz,) = torch.autograd.grad(theta.sum(), zz, create_graph=need_graph)
                ld = torch.sum(torch.log(torch.abs(dz)), dim=-1)
            else:
                rows = [torch.autograd.grad(theta[..., j].sum(), zz, create_graph=need_graph,
                                            retain_graph=True)[0] for j in range(d)]
                ld = torch.linalg.slogdet(torch.stack(rows, dim=-2))[1]
        if not need_graph:
            theta, ld = theta.detach(), ld.detach()
        return theta, ld

    return _ZSpace(list(keys), d, spec, theta_of_z, map_logdet, z0, log_v,
                   scales if spec is None else None)


def _floored(lp):
    return torch.where(torch.isfinite(lp), lp, _FLOOR)


def _logp_z_fn(zs: _ZSpace, posterior):
    """``z (..., d) -> (...)``: ``posterior(theta) + log|J|``, a non-finite
    value floored to -1e12 (JAX ``logp_z``)."""
    def logp_z(z):
        theta, ld = zs.map_logdet(z)
        return _floored(posterior(theta) + ld)

    return logp_z


def _resolved_spec(fit, prior, bounds, caller: str):
    """The prior spec of ``fit`` (``resolve_prior_spec``), checked to cover
    every parameter."""
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(fit, prior, bounds)
    if spec is not None:
        missing = [k for k in fit.spec.keys if k not in spec]
        if missing:
            raise ValueError(f"{caller}: prior/bounds missing {missing}")
    return spec


def _walker_z_space(walker, prior, bounds, caller: str, scales=None) -> _ZSpace:
    refuse_multi_process(walker, caller)
    spec = _resolved_spec(walker, prior, bounds, caller)
    pos = _host(walker.state.position).astype(np.float64)
    return _z_space(list(walker.spec.keys), spec, pos, walker.dtype, walker.device,
                    scales=scales)


def _fit_z_space(fit, prior, bounds, caller: str) -> _ZSpace:
    if getattr(fit, "n_datasets", None) is None:
        raise ValueError(f"{caller} needs a BatchedFit")
    refuse_multi_process(fit, caller)
    spec = _resolved_spec(fit, prior, bounds, caller)
    S, d = int(fit.n_datasets), fit.spec.ndim
    pos = _host(fit.state.position).astype(np.float64).reshape(S, -1, d)
    return _z_space(list(fit.spec.keys), spec, pos, fit.dtype, fit.device, batched=True)


def _dataset_maps(fit, zs: _ZSpace, s: int):
    """Dataset ``s``'s own ``theta_of_z`` and differentiable ``logp_z`` on
    ``(n, d)`` rows (its results' ``sample`` and NeuTra surface)."""
    one = zs if zs.spec is not None else _z_space(
        zs.keys, None, zs.z0[s] * zs.scales[s], fit.dtype, fit.device, scales=zs.scales[s])
    data = fit._posterior_data()
    idx = torch.tensor(s, device=fit.device)
    per_walker = torch.func.vmap(lambda th: fit._custom_log_post(th, idx, data))
    return one.theta_of_z, _logp_z_fn(one, per_walker)


# ------------------------------------------------------------ the results


@dataclasses.dataclass(frozen=True)
class VIResult:
    """A fitted Gaussian variational posterior (JAX ``VIResult``).

    ``mean``/``sd``/``cov``: parameter-space moments of ``n_eval`` q draws.
    ``elbo`` the evidence lower bound, ``log_z`` the importance-sampled
    evidence and ``log_z_error`` its 8-batch standard error (None without
    a resolvable prior spec), ``pareto_k`` the weight-tail diagnostic;
    ``converged_evidence`` says whether to trust ``log_z``.  ``elbo_trace``
    the per-step ELBO.
    """

    keys: tuple
    mean: dict
    sd: dict
    cov: np.ndarray
    elbo: float | None
    log_z: float | None
    log_z_error: float | None
    pareto_k: float
    elbo_trace: np.ndarray
    rank: str
    n_steps: int
    # the z-space Gaussian (mu, L) and the z -> theta map, for sample()
    _mu: np.ndarray = dataclasses.field(repr=False)
    _chol: np.ndarray = dataclasses.field(repr=False)
    _theta_of_z: object = dataclasses.field(repr=False)
    _dtype: object = dataclasses.field(repr=False)
    _device: object = dataclasses.field(repr=False)

    @property
    def converged_evidence(self) -> bool:
        """True when ``log_z`` carries a healthy weight tail (k < 0.7)."""
        return self.log_z is not None and np.isfinite(self.pareto_k) \
            and self.pareto_k < 0.7

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """(n, d) parameter-space draws from q, eps from a generator seeded
        from ``seed`` on the fit's device."""
        kw = dict(dtype=self._dtype, device=self._device)
        eps = _draws(_generator(self._device, seed), (int(n), self._mu.size), **kw)
        with torch.no_grad():
            z = torch.as_tensor(self._mu, **kw) + eps @ torch.as_tensor(self._chol, **kw).T
            return _host(self._theta_of_z(z)).astype(np.float64)

    def summary(self) -> dict:
        return {k: (self.mean[k], self.sd[k]) for k in self.keys}

    def to_mvgaussian(self, inflate: float = 1.0):
        """The moment-matched correlated prior of the next experiment;
        ``inflate`` scales the standard deviations."""
        from .priors import MVGaussian

        return MVGaussian({k: self.mean[k] for k in self.keys},
                          float(inflate) ** 2 * self.cov)

    def seed_walker(self, walker, seed: int = 0):
        """Re-draw ``walker``'s ensemble from q: positions, logprobs and
        best points replaced, history dropped, L and moments kept."""
        refuse_multi_process(walker, "seed_walker")
        pos = torch.as_tensor(self.sample(walker.n_walkers, seed=seed),
                              dtype=walker.dtype, device=walker.device)
        walker.state = dataclasses.replace(walker.state, position=pos)
        lp = walker._eval_batch(pos)
        walker.reset()
        walker.state = dataclasses.replace(walker.state, logprob=lp,
                                           best_position=pos, best_logprob=lp)
        return walker

    def __repr__(self):
        z = "None" if self.log_z is None else f"{self.log_z:.4f}"
        e = "None" if self.elbo is None else f"{self.elbo:.4f}"
        return (f"VIResult(rank={self.rank!r}, elbo={e}, log_z={z}, "
                f"pareto_k={self.pareto_k:.3f}, "
                f"trust_log_z={self.converged_evidence})")


# ------------------------------------------------------------ Gaussian q


def _gaussian_layout(rank: str, d: int):
    if rank not in ("full", "meanfield"):
        raise ValueError(f"rank must be 'full' or 'meanfield', got {rank!r}")
    entries = [("mu", (d,)), ("raw", (d,))]
    if rank == "full":
        entries.append(("low", (d, d)))
    return _layout(entries)


def _build_l(p: dict):
    """q's Cholesky factor: the strict lower triangle of ``low`` (full
    rank) plus ``diag(exp(raw))``."""
    diag = torch.diag_embed(torch.exp(p["raw"]))
    return diag + torch.tril(p["low"], -1) if "low" in p else diag


def _entropy(p: dict, d: int):
    return torch.sum(p["raw"], dim=-1) + 0.5 * d * (1.0 + _LOG_2PI)


def _gaussian_init(z0: np.ndarray, rank: str) -> dict:
    """q's z-space start from an ensemble block ``(B, d)`` (JAX
    variational.py:367-383): its mean, sd (ddof 1, at least 1e-3) and, full
    rank, the Cholesky factor of its covariance (+1e-6 sd^2 on the
    diagonal; the sd diagonal where that fails)."""
    d = z0.shape[1]
    mu0 = z0.mean(axis=0)
    if z0.shape[0] >= 2:
        sd0 = np.maximum(z0.std(axis=0, ddof=1), 1e-3)
        cov0 = np.atleast_2d(np.cov(z0.T)) + np.diag(1e-6 * sd0 ** 2)
    else:
        sd0 = np.full(d, 0.1)
        cov0 = np.diag(sd0 ** 2)
    if rank != "full":
        return {"mu": mu0, "raw": np.log(sd0)}
    try:
        l0 = np.linalg.cholesky(cov0)
    except np.linalg.LinAlgError:
        l0 = np.diag(sd0)
    return {"mu": mu0, "raw": np.log(np.diag(l0)), "low": np.tril(l0, k=-1)}


def _gaussian_draws(p: dict, eps):
    chol = _build_l(p)
    z = p["mu"].unsqueeze(-2) + eps @ chol.transpose(-1, -2)
    logq = (-0.5 * torch.sum(eps * eps, dim=-1) - 0.5 * eps.shape[-1] * _LOG_2PI
            - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1,
                        keepdim=True))
    return z, logq


def _check_steps(n_steps, n_samples):
    if n_steps <= 0 or n_samples <= 0:
        raise ValueError("n_steps and n_samples must be positive")


def advi(walker, prior=None, bounds=None, rank: str = "full",
         n_steps: int = 1500, n_samples: int = 8,
         learning_rate: float = 0.05, n_eval: int = 2048,
         seed: int = 0) -> VIResult:
    """Fit a Gaussian variational posterior to the walker's target (JAX
    ``advi``, variational.py:323-474).

    ``rank="full"``: a dense Cholesky factor; ``"meanfield"``: a diagonal.
    ``prior``/``bounds`` resolve as :func:`~lisp_mcmc_torch.evidence.
    laplace_approx` does (explicit, then the fit's ``_prior_spec``, then its
    ``_bounds``).  q starts from the current ensemble's z-space moments;
    ``n_steps`` Adam steps on ``n_samples`` draws each (clipped at global
    norm 10, cosine-decayed rate, floor 0.05 of ``learning_rate``), the
    iterates of the last quarter averaged.  ``n_eval`` evaluation draws
    give the moments, the evidence and Pareto k; their posterior values
    run on kernel 1 on CUDA where the fit is inside its coverage.  The
    walker is untouched (:meth:`VIResult.seed_walker` adopts the result);
    a fit with per-walker aux is refused.
    """
    if getattr(walker, "aux", None) is not None:
        raise ValueError("advi: grouped/aux ensembles have no single "
                         "posterior surface; use "
                         "BatchedFit.advi_per_dataset (one vmapped scan "
                         "fits every dataset's q)")
    _check_steps(n_steps, n_samples)
    layout = _gaussian_layout(rank, len(walker.spec.keys))
    zs = _walker_z_space(walker, prior, bounds, "advi")
    d, dtype, device = zs.d, walker.dtype, walker.device
    init = _gaussian_init(zs.z0, rank)
    flat0 = _flat_from({k: v[None] for k, v in init.items()}, layout, 1, dtype, device)
    logp_z = _logp_z_fn(zs, walker._log_post)

    def neg_elbo(p, eps):
        z, _ = _gaussian_draws(p, eps)
        return -(torch.mean(logp_z(z), dim=-1) + _entropy(p, d))

    flat, trace = _run_optimizer(flat0, layout, False, neg_elbo, (int(n_samples), d),
                                 int(n_steps), learning_rate, 0.05, 0.75, seed)
    p = _views(flat, layout, False)
    eps = _draws(_generator(device, seed + 1), (int(n_eval), d), dtype, device)
    theta, lw = _evaluate(_gaussian_draws, p, eps, zs, walker._batched_posterior())
    return _gaussian_result(zs, p, theta, lw, trace[:, 0], rank, n_steps, dtype, device,
                            zs.theta_of_z)


@torch.no_grad()
def _evaluate(draw, p, eps, zs: _ZSpace, posterior):
    """``(theta, log p - log q)`` of q's evaluation draws as numpy; ``draw(p,
    eps) -> (z, log q(z))`` is the family's reparameterization."""
    z, logq = draw(p, eps)
    theta, ld = zs.map_logdet(z)
    lp = _floored(posterior(theta) + ld)
    return _host(theta).astype(np.float64), _host(lp - logq).astype(np.float64)


def _gaussian_result(zs, p, theta, lw, trace, rank, n_steps, dtype, device, theta_of_z):
    mean, sd, cov = _moments(theta, zs.keys)
    elbo, log_z, err = _evidence(lw, zs.spec, zs.log_v)
    return VIResult(
        keys=tuple(zs.keys), mean=mean, sd=sd, cov=cov, elbo=elbo, log_z=log_z,
        log_z_error=err, pareto_k=_pareto_k(lw), elbo_trace=trace, rank=rank,
        n_steps=int(n_steps), _mu=_host(p["mu"]).astype(np.float64),
        _chol=_host(_build_l(p)).astype(np.float64), _theta_of_z=theta_of_z,
        _dtype=dtype, _device=device)


def advi_per_dataset(fit, prior=None, bounds=None, rank: str = "full",
                     n_steps: int = 1500, n_samples: int = 8,
                     learning_rate: float = 0.05, n_eval: int = 1024,
                     seed: int = 0) -> list:
    """S per-dataset ADVI fits in one batched loop (JAX
    ``advi_per_dataset``, variational.py:477-675).

    Every dataset block gets its own q, started from its own walker
    block's z-moments, with its own gradient clipping and Adam state: the
    q parameters are the rows of one ``(S, P)`` buffer, the S ELBOs one
    batched evaluation of the plain batched posterior
    (``BatchedFit._dataset_posterior``).  ``prior``/``bounds`` are shared
    by the datasets; without a spec each block is whitened by its own
    scales.  Returns S :class:`VIResult`.
    """
    zs = _fit_z_space(fit, prior, bounds, "advi_per_dataset")
    _check_steps(n_steps, n_samples)
    S, d, dtype, device = int(fit.n_datasets), zs.d, fit.dtype, fit.device
    layout = _gaussian_layout(rank, d)
    inits = [_gaussian_init(zs.z0[s], rank) for s in range(S)]
    flat0 = _flat_from({k: np.stack([i[k] for i in inits]) for k in inits[0]}, layout,
                       S, dtype, device)
    logp_z = _logp_z_fn(zs, fit._dataset_posterior)

    def neg_elbo(p, eps):
        z, _ = _gaussian_draws(p, eps)
        return -(torch.mean(logp_z(z), dim=-1) + _entropy(p, d))

    flat, traces = _run_optimizer(flat0, layout, True, neg_elbo, (S, int(n_samples), d),
                                  int(n_steps), learning_rate, 0.05, 0.75, seed)
    p = _views(flat, layout, True)
    eps = _draws(_generator(device, seed + 1), (S, int(n_eval), d), dtype, device)
    thetas, lws = _evaluate(_gaussian_draws, p, eps, zs, fit._dataset_posterior)
    out = []
    for s in range(S):
        p_s = {k: v[s] for k, v in p.items()}
        theta_of_z, _ = _dataset_maps(fit, zs, s)
        out.append(_gaussian_result(zs, p_s, thetas[s], lws[s], traces[:, s], rank,
                                    n_steps, dtype, device, theta_of_z))
    return out


# ------------------------------------------------------------ the flow


def _flow_masks(d: int, n_layers: int, dtype, device):
    """The couplings' alternating masks: layer k keeps the coordinates of
    parity k."""
    return torch.as_tensor(
        np.stack([(np.arange(d) % 2 == k % 2).astype(np.float64)
                  for k in range(n_layers)]), dtype=dtype, device=device)


def _flow_forward_fn(d: int, n_layers: int, s_cap: float, dtype, device):
    """The RealNVP forward pass ``(params, eps) -> (z, log|det dz/deps|)``
    (JAX ``_flow_forward_fn``): ``n_layers`` affine couplings, each a tanh
    MLP of the kept half emitting a shift and a log-scale soft-clamped to
    ``s_cap``, then the global affine ``mu + exp(raw) y``.  ``params`` as
    the JAX package keys them (``mu``, ``raw``, ``layers[k][w1 .. b3]``);
    with a leading S axis on every leaf (and on eps) it runs S flows."""
    masks = _flow_masks(d, n_layers, dtype, device)
    cap = float(s_cap)

    def flow_forward(p, eps):
        y = eps
        ld = torch.zeros(eps.shape[:-1], dtype=eps.dtype, device=eps.device)
        for k, lay in enumerate(p["layers"]):
            m = masks[k]
            h = torch.tanh((y * m) @ lay["w1"] + lay["b1"].unsqueeze(-2))
            h = torch.tanh(h @ lay["w2"] + lay["b2"].unsqueeze(-2))
            out = h @ lay["w3"] + lay["b3"].unsqueeze(-2)
            s = cap * torch.tanh(out[..., :d] / cap)
            t = out[..., d:]
            y = m * y + (1.0 - m) * (y * torch.exp(s) + t)
            ld = ld + torch.sum((1.0 - m) * s, dim=-1)
        z = p["mu"].unsqueeze(-2) + torch.exp(p["raw"]).unsqueeze(-2) * y
        return z, ld + torch.sum(p["raw"], dim=-1, keepdim=True)

    return flow_forward


def _flow_layout(d: int, hidden: int, n_layers: int):
    entries = [("mu", (d,)), ("raw", (d,))]
    shapes = {"w1": (d, hidden), "b1": (hidden,), "w2": (hidden, hidden),
              "b2": (hidden,), "w3": (hidden, 2 * d), "b3": (2 * d,)}
    for k in range(n_layers):
        entries.extend((f"layers.{k}.{n}", shapes[n]) for n in _LAYER_LEAVES)
    return _layout(entries)


def _flow_init(rng, lead: tuple, d: int, hidden: int, n_layers: int) -> list:
    """The couplings' start, drawn as the JAX package draws them: per
    layer ``w1 ~ N(0, 0.01)`` then ``w2``, from one numpy Generator; zero
    biases and a zero last layer (each coupling the identity)."""
    layers = []
    for _ in range(n_layers):
        layers.append({
            "w1": rng.normal(0, 0.01, (*lead, d, hidden)),
            "b1": np.zeros((*lead, hidden)),
            "w2": rng.normal(0, 0.01, (*lead, hidden, hidden)),
            "b2": np.zeros((*lead, hidden)),
            "w3": np.zeros((*lead, hidden, 2 * d)),
            "b3": np.zeros((*lead, 2 * d)),
        })
    return layers


def _check_flow_args(n_steps, n_samples, n_layers, hidden):
    if n_steps <= 0 or n_samples <= 0 or n_layers <= 0 or hidden <= 0:
        raise ValueError("n_steps, n_samples, n_layers, hidden must be "
                         "positive")


def _flow_draws(flow_forward, p, eps):
    """``(z, log q(z))`` of the flow's reparameterized draws."""
    z, ld = flow_forward(p, eps)
    logq = -0.5 * torch.sum(eps * eps, dim=-1) - 0.5 * eps.shape[-1] * _LOG_2PI - ld
    return z, logq


def _numpy_params(p: dict) -> dict:
    return {"mu": _host(p["mu"]).astype(np.float64),
            "raw": _host(p["raw"]).astype(np.float64),
            "layers": [{n: _host(lay[n]).astype(np.float64) for n in _LAYER_LEAVES}
                       for lay in p["layers"]]}


def _torch_params(params: dict, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"mu": torch.as_tensor(np.asarray(params["mu"]), **kw),
            "raw": torch.as_tensor(np.asarray(params["raw"]), **kw),
            "layers": [{n: torch.as_tensor(np.asarray(lay[n]), **kw) for n in _LAYER_LEAVES}
                       for lay in params["layers"]]}


@dataclasses.dataclass(frozen=True)
class NeutraResult:
    """Posterior draws from :meth:`FlowVIResult.neutra_sample`: the flat
    ``(T*W, d)`` history ``samples``, its ``(T, W, d)`` chain view
    ``samples_by_step``, the latent chain's ``logprobs`` and
    ``acceptance``, and the latent fit itself."""

    keys: tuple
    samples: np.ndarray
    samples_by_step: np.ndarray
    logprobs: np.ndarray
    acceptance: float
    latent: object = dataclasses.field(repr=False)

    def mean(self) -> dict:
        m = self.samples.mean(axis=0)
        return {k: float(m[i]) for i, k in enumerate(self.keys)}

    def min_ess(self, max_chains: int = 64) -> float:
        """Min ESS over parameters of the mapped chains (up to
        ``max_chains`` evenly spaced walkers)."""
        from .ops.reductions import effective_sample_size

        T, W, d = self.samples_by_step.shape
        take = min(W, max_chains)
        idx = np.linspace(0, W - 1, take).astype(int)
        chains = self.samples_by_step[:, idx, :]
        return min(float(effective_sample_size(torch.as_tensor(chains[:, :, j])))
                   for j in range(d))

    def __repr__(self):
        return (f"NeutraResult(n={self.samples.shape[0]}, "
                f"acceptance={self.acceptance:.3f})")


@dataclasses.dataclass(frozen=True)
class FlowVIResult(VIResult):
    """A fitted RealNVP variational posterior (see :func:`flow_advi`).

    The Gaussian summary fields are moment-matched from flow draws;
    :meth:`sample` (so ``seed_walker``) draws through the flow,
    :meth:`save` checkpoints it and :meth:`neutra_sample` samples in its
    latent space.
    """

    _z_of_eps: object = dataclasses.field(default=None, repr=False)
    _fwd: object = dataclasses.field(default=None, repr=False)
    _logp_z: object = dataclasses.field(default=None, repr=False)
    _params: object = dataclasses.field(default=None, repr=False)
    _hidden: int = dataclasses.field(default=0, repr=False)
    _s_cap: float = dataclasses.field(default=3.0, repr=False)
    _scales: object = dataclasses.field(default=None, repr=False)
    n_layers: int = 0

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        eps = _draws(_generator(self._device, seed), (int(n), len(self.keys)),
                     self._dtype, self._device)
        with torch.no_grad():
            return _host(self._theta_of_z(self._z_of_eps(eps))).astype(np.float64)

    def save(self, path: str) -> None:
        """Checkpoint the trained transport as an ``.npz`` that both
        packages' ``load_flow`` read: ``mu``, ``raw``, ``layer{k}_{name}``,
        ``cov``, ``elbo_trace``, ``flow_mu``, ``flow_chol``, ``scales`` (a
        no-spec fit's frozen whitening) and the ``__flow_header__`` JSON."""
        if self._params is None:
            raise ValueError("this FlowVIResult predates the checkpoint "
                             "surface; refit with flow_advi")
        arrays = {
            "mu": np.asarray(self._params["mu"], np.float64),
            "raw": np.asarray(self._params["raw"], np.float64),
            "cov": np.asarray(self.cov, np.float64),
            "elbo_trace": np.asarray(self.elbo_trace, np.float64),
            "flow_mu": np.asarray(self._mu, np.float64),
            "flow_chol": np.asarray(self._chol, np.float64),
        }
        for k, lay in enumerate(self._params["layers"]):
            for name, a in lay.items():
                arrays[f"layer{k}_{name}"] = np.asarray(a, np.float64)
        if self._scales is not None:
            arrays["scales"] = np.asarray(self._scales, np.float64)
        header = {
            "kind": "flow_advi", "keys": list(self.keys),
            "n_layers": int(self.n_layers), "hidden": int(self._hidden),
            "s_cap": float(self._s_cap), "rank": self.rank,
            "n_steps": int(self.n_steps), "dtype": _dtype_name(self._dtype),
            "mean": {k: float(v) for k, v in self.mean.items()},
            "sd": {k: float(v) for k, v in self.sd.items()},
            "elbo": self.elbo, "log_z": self.log_z,
            "log_z_error": self.log_z_error,
            "pareto_k": float(self.pareto_k),
        }
        arrays["__flow_header__"] = np.array(json.dumps(header))
        np.savez(path, **arrays)

    def neutra_sample(self, walker, n_steps: int = 4000,
                      kernel: str = "chees", n_walkers: int | None = None,
                      seed: int = 0, **config_overrides) -> NeutraResult:
        """Exact posterior samples by MCMC in the flow's latent space
        (NeuTra; JAX ``FlowVIResult.neutra_sample``).

        A fresh latent fit (the caller's walker is untouched): a null model
        whose likelihood is ``log p(T(eps)) + log|det dT/deps|`` of the
        posterior the flow was fitted (or loaded) against, ``n_walkers``
        (default the walker's) started at eps ~ N(0, I) (the generator
        seeded from ``seed + 7``), L = Haario's ``2.38^2 / d`` times I,
        then ``n_steps`` cold adaptive steps with ``kernel``; the retained
        history is mapped back through T.  The latent fit runs the plain
        posterior (a custom likelihood is outside the kernels' coverage).
        """
        from .fit import walker_create
        from .kernel import FitConfig
        from .ops.linalg import haario_scale

        if self._fwd is None or self._logp_z is None:
            raise ValueError("neutra_sample: this FlowVIResult predates "
                             "the NeuTra surface; refit with flow_advi")
        keys = list(self.keys)
        d = len(keys)
        n_w = int(n_walkers or walker.n_walkers)
        fwd, logp_z = self._fwd, self._logp_z

        def latent_loglik(fn, params, dataset):
            eps = torch.stack([params[k].reshape(-1) for k in keys], dim=-1)
            z, ld = fwd(eps)
            return logp_z(z) + ld

        def null_model(x, p):
            return torch.zeros_like(x)

        latent = walker_create(
            function=null_model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.0 for k in keys}, log_likelihood=latent_loglik,
            n_walkers=n_w, seed=seed, walker_jitter=0.0,
            config=FitConfig(kernel=kernel, **config_overrides), dtype=self._dtype,
            device=self._device)
        eps0 = _draws(_generator(self._device, seed + 7), (n_w, d), self._dtype,
                      self._device)
        lp0 = latent._eval_batch(eps0)
        latent.state = dataclasses.replace(latent.state, position=eps0, logprob=lp0,
                                           best_position=eps0, best_logprob=lp0)
        latent._set_l_matrix(float(haario_scale(d)) * np.eye(d))
        latent.adaptive_steps(int(n_steps), temperature=1.0, auto=None)

        eps_hist, lp_hist = latent._history(None)            # (T, W, d)
        T, W, _ = eps_hist.shape
        with torch.no_grad():
            flat = torch.as_tensor(eps_hist.reshape(-1, d), dtype=self._dtype,
                                   device=self._device)
            theta = _host(self._theta_of_z(fwd(flat)[0])).astype(np.float64)
        return NeutraResult(keys=tuple(keys), samples=theta,
                            samples_by_step=theta.reshape(T, W, d),
                            logprobs=np.asarray(lp_hist, np.float64).reshape(-1),
                            acceptance=float(latent.acceptance()), latent=latent)

    def __repr__(self):
        z = "None" if self.log_z is None else f"{self.log_z:.4f}"
        e = "None" if self.elbo is None else f"{self.elbo:.4f}"
        return (f"FlowVIResult(n_layers={self.n_layers}, elbo={e}, "
                f"log_z={z}, pareto_k={self.pareto_k:.3f}, "
                f"trust_log_z={self.converged_evidence})")


def _flow_surface(params_np: dict, d: int, n_layers: int, s_cap: float, dtype,
                  device):
    """``eps -> (z, log|det|)`` of one flow's numpy parameters, on ``device``."""
    tp = _torch_params(params_np, dtype, device)
    fwd_fn = _flow_forward_fn(d, n_layers, s_cap, dtype, device)
    return lambda eps: fwd_fn(tp, eps)


def _flow_result(keys, params_np, theta, lw, trace, spec, log_v, n_steps, theta_of_z,
                 logp_z, hidden, s_cap, scales, n_layers, dtype, device) -> FlowVIResult:
    """A :class:`FlowVIResult` from one flow's numpy parameters and its
    evaluation draws."""
    mean, sd, cov = _moments(theta, keys)
    elbo, log_z, err = _evidence(lw, spec, log_v)
    fwd = _flow_surface(params_np, len(keys), n_layers, s_cap, dtype, device)
    return FlowVIResult(
        keys=tuple(keys), mean=mean, sd=sd, cov=cov, elbo=elbo, log_z=log_z,
        log_z_error=err, pareto_k=_pareto_k(lw), elbo_trace=trace, rank="flow",
        n_steps=int(n_steps), _mu=np.asarray(params_np["mu"], np.float64),
        _chol=np.diag(np.exp(np.asarray(params_np["raw"], np.float64))),
        _theta_of_z=theta_of_z, _dtype=dtype, _device=device,
        _z_of_eps=lambda eps: fwd(eps)[0], _fwd=fwd, _logp_z=logp_z,
        _params=params_np, _hidden=int(hidden), _s_cap=float(s_cap),
        _scales=None if scales is None else np.asarray(scales, np.float64),
        n_layers=int(n_layers))


def _train_flow(flat0, layout, batched, logp_z, flow_forward, eps_shape, n_steps,
                learning_rate, seed):
    def neg_elbo(p, eps):
        z, logq = _flow_draws(flow_forward, p, eps)
        return -torch.mean(logp_z(z) - logq, dim=-1)

    # The flow's regime (JAX variational.py:1006-1019): a gentler decay
    # floor (0.3) and the last 10 % averaged.
    return _run_optimizer(flat0, layout, batched, neg_elbo, eps_shape, int(n_steps),
                          learning_rate, 0.3, 0.9, seed)


def flow_advi(walker, prior=None, bounds=None, n_layers: int = 4,
              hidden: int = 32, n_steps: int = 12000, n_samples: int = 256,
              learning_rate: float = 1e-3, s_cap: float = 3.0,
              n_eval: int = 4096, seed: int = 0) -> FlowVIResult:
    """Fit a RealNVP normalizing-flow posterior (JAX ``flow_advi``,
    variational.py:921-1087): ``q = T(N(0, I))``, ``n_layers`` affine
    couplings of width ``hidden`` (identity at the start: a zero last
    layer) after a global affine started at the ensemble's z-moments, in
    :func:`advi`'s z-space.  The coupling weights are drawn from
    ``np.random.default_rng(seed)`` as the JAX package draws them; Adam
    with a 0.3 decay floor, the last 10 % of the iterates averaged.  The
    evaluation draws run on kernel 1 on CUDA where the fit is inside its
    coverage."""
    if getattr(walker, "aux", None) is not None:
        raise ValueError("flow_advi: grouped/aux ensembles have no single "
                         "posterior surface; fit per-dataset views")
    _check_flow_args(n_steps, n_samples, n_layers, hidden)
    zs = _walker_z_space(walker, prior, bounds, "flow_advi")
    d, dtype, device, n_layers = zs.d, walker.dtype, walker.device, int(n_layers)
    mu0 = zs.z0.mean(axis=0)
    sd0 = (np.maximum(zs.z0.std(axis=0, ddof=1), 1e-3)
           if zs.z0.shape[0] >= 2 else np.full(d, 0.1))
    rng = np.random.default_rng(seed)
    init = {"mu": mu0[None], "raw": np.log(sd0)[None],
            "layers": _flow_init(rng, (1,), d, hidden, n_layers)}
    layout = _flow_layout(d, hidden, n_layers)
    flow_forward = _flow_forward_fn(d, n_layers, s_cap, dtype, device)
    logp_z = _logp_z_fn(zs, walker._log_post)
    flat, trace = _train_flow(_flat_from(init, layout, 1, dtype, device), layout, False,
                              logp_z, flow_forward, (int(n_samples), d), n_steps,
                              learning_rate, seed)
    p = _views(flat, layout, False)
    eps = _draws(_generator(device, seed + 1), (int(n_eval), d), dtype, device)
    theta, lw = _evaluate(lambda q, e: _flow_draws(flow_forward, q, e), p, eps, zs,
                         walker._batched_posterior())
    return _flow_result(zs.keys, _numpy_params(p), theta, lw, trace[:, 0], zs.spec,
                        zs.log_v, n_steps, zs.theta_of_z, logp_z, hidden, s_cap,
                        zs.scales, n_layers, dtype, device)


def flow_advi_per_dataset(fit, prior=None, bounds=None, n_layers: int = 4,
                          hidden: int = 32, n_steps: int = 12000,
                          n_samples: int = 256, learning_rate: float = 1e-3,
                          s_cap: float = 3.0, n_eval: int = 2048,
                          seed: int = 0) -> list:
    """S per-dataset RealNVP flows in one batched loop (JAX
    ``flow_advi_per_dataset``, variational.py:1090-1295): each dataset
    block trains its own coupling stack, started at its own block's
    z-moments, the S stacks as the rows of one parameter buffer (batched
    matmuls), on the plain batched posterior.  Returns S
    :class:`FlowVIResult`, each with its own checkpoint and NeuTra
    surface."""
    zs = _fit_z_space(fit, prior, bounds, "flow_advi_per_dataset")
    _check_flow_args(n_steps, n_samples, n_layers, hidden)
    S, d, dtype, device = int(fit.n_datasets), zs.d, fit.dtype, fit.device
    n_layers = int(n_layers)
    mu0 = zs.z0.mean(axis=1)
    sd0 = np.maximum(zs.z0.std(axis=1, ddof=1), 1e-3)
    rng = np.random.default_rng(seed)
    init = {"mu": mu0, "raw": np.log(sd0),
            "layers": _flow_init(rng, (S,), d, hidden, n_layers)}
    layout = _flow_layout(d, hidden, n_layers)
    flow_forward = _flow_forward_fn(d, n_layers, s_cap, dtype, device)
    logp_z = _logp_z_fn(zs, fit._dataset_posterior)
    flat, traces = _train_flow(_flat_from(init, layout, S, dtype, device), layout, True,
                               logp_z, flow_forward, (S, int(n_samples), d), n_steps,
                               learning_rate, seed)
    p = _views(flat, layout, True)
    eps = _draws(_generator(device, seed + 1), (S, int(n_eval), d), dtype, device)
    thetas, lws = _evaluate(lambda q, e: _flow_draws(flow_forward, q, e), p, eps, zs,
                           fit._dataset_posterior)
    params = _numpy_params(p)
    out = []
    for s in range(S):
        p_s = {"mu": params["mu"][s], "raw": params["raw"][s],
               "layers": [{n: lay[n][s] for n in _LAYER_LEAVES} for lay in params["layers"]]}
        theta_of_z, logp_s = _dataset_maps(fit, zs, s)
        out.append(_flow_result(zs.keys, p_s, thetas[s], lws[s], traces[:, s], zs.spec,
                                zs.log_v, n_steps, theta_of_z, logp_s, hidden, s_cap,
                                None if zs.scales is None else zs.scales[s], n_layers,
                                dtype, device))
    return out


def load_flow(path: str, walker, prior=None, bounds=None) -> FlowVIResult:
    """Reload a :meth:`FlowVIResult.save` checkpoint (this package's or the
    JAX package's) against ``walker`` (JAX ``load_flow``): the walker gives
    the posterior and, resolved as usual, the prior spec whose map the flow
    was trained through; a no-spec checkpoint's frozen scales rebuild the
    training-time map.  A spec/no-spec mismatch raises.  The saved
    summaries come back as they were; nothing is retrained."""
    with np.load(path, allow_pickle=False) as z:
        if "__flow_header__" not in z.files:
            raise ValueError(f"{path}: not a flow_advi checkpoint")
        header = json.loads(str(z["__flow_header__"][()]))
        arrays = {k: z[k] for k in z.files if k != "__flow_header__"}

    keys_saved = list(header["keys"])
    if list(walker.spec.keys) != keys_saved:
        raise ValueError(
            f"load_flow: walker parameters {list(walker.spec.keys)} do not "
            f"match the checkpoint's {keys_saved}")
    scales = arrays.get("scales")
    zs = _walker_z_space(walker, prior, bounds, "load_flow", scales=scales)
    if (zs.spec is None) != (scales is not None):
        raise ValueError(
            "load_flow: the checkpoint was trained "
            + ("WITHOUT" if scales is not None else "WITH")
            + " a resolvable prior spec, but this walker resolves the "
            "opposite — the z-space maps would disagree; reload against a "
            "fit constructed like the one that trained the flow")
    dtype = torch.float64 if header["dtype"] == "float64" else torch.float32
    n_layers = int(header["n_layers"])
    params = {"mu": arrays["mu"], "raw": arrays["raw"],
              "layers": [{n: arrays[f"layer{k}_{n}"] for n in _LAYER_LEAVES}
                         for k in range(n_layers)]}
    fwd = _flow_surface(params, len(keys_saved), n_layers, float(header["s_cap"]), dtype,
                        walker.device)
    return FlowVIResult(
        keys=tuple(keys_saved), mean=dict(header["mean"]), sd=dict(header["sd"]),
        cov=np.asarray(arrays["cov"], np.float64), elbo=header["elbo"],
        log_z=header["log_z"], log_z_error=header["log_z_error"],
        pareto_k=float(header["pareto_k"]),
        elbo_trace=np.asarray(arrays["elbo_trace"], np.float64), rank=header["rank"],
        n_steps=int(header["n_steps"]), _mu=np.asarray(arrays["flow_mu"], np.float64),
        _chol=np.asarray(arrays["flow_chol"], np.float64), _theta_of_z=zs.theta_of_z,
        _dtype=dtype, _device=walker.device, _z_of_eps=lambda eps: fwd(eps)[0], _fwd=fwd,
        _logp_z=_logp_z_fn(zs, walker._log_post),
        _params={"mu": np.asarray(params["mu"], np.float64),
                 "raw": np.asarray(params["raw"], np.float64),
                 "layers": [{n: np.asarray(a, np.float64) for n, a in lay.items()}
                            for lay in params["layers"]]},
        _hidden=int(header["hidden"]), _s_cap=float(header["s_cap"]),
        _scales=None if scales is None else np.asarray(scales, np.float64),
        n_layers=n_layers)
