"""Chain-axis data parallelism over processes (reference C23/C24).

Port of ``lisp_mcmc_tpu/parallel/mesh.py`` on ``torch.distributed``, in
PyTorch's own idiom: one process per GPU, each holding a contiguous
slice of the walker ensemble.  The reference has no parallelism of any
kind -- its only "many chains" notion is a Lisp list of walkers advanced
one after another (nv-specific.lisp:58-66).

The JAX package gets its collectives from GSPMD: the kernel's pooled
reductions over the walker axis become all-reduces when its inputs are
sharded.  PyTorch has no such partitioner, so the chunk runner
(``kernel.build_chunk_runner(mesh=...)``) calls the collectives itself,
at named sites, through :class:`ChainComm`:

  - a rwm chunk: one all-reduce at its end of the moment increments
    ``(G, d) + (G, d, d) + (G,)``, the acceptance counts and the per-step
    trace (the single cross-chain all-reduce for pooled covariance
    adaptation; the ``lplist-covariance`` + ``cholesky-decomp`` step at
    mcmc-fitting.lisp:614/583 becomes all-reduce(moments) -> a Cholesky
    every rank computes alike, so L stays replicated);
  - a gradient chunk (mala, hmc, chees; blocked proposals alike): the same
    all-reduce, which also gathers every walker's position, logprob and
    best point for the typical-set or ensemble refresh and the
    independence rescue, plus one all-reduce per rescue half-round; chees
    adds two per step (its group sums; its leapfrog count needs none, as
    the ChEES state is replicated and every rank draws the same jitter);
  - an ensemble chunk (stretch, demc, slice): one all-reduce at its start
    gathers the ensemble, every rank runs the chunk on it alike, and each
    posterior evaluation is split by the ranks that hold the walkers,
    one all-reduce each (slice's "every walker done" poll then reads the
    same flags on every rank and needs none).

Every all-reduce is a SUM of a buffer that is zero outside the rank's own
entries, so a "gather" is exact and every rank reads the same numbers.
Every rank draws the whole ensemble's noise from the one seeded
generator and keeps its rows, so a sharded chunk draws what the
unsharded one does.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from ..kernel import WalkerState

CHAIN_AXIS = "chains"

__all__ = [
    "CHAIN_AXIS",
    "initialize_distributed",
    "make_mesh",
    "replicated",
    "state_shardings",
    "shard_state",
    "chain_comm",
    "ChainComm",
]

_log = logging.getLogger(__name__)


def _coordinator_configured(kwargs) -> bool:
    """True when the caller or the launch environment names a coordinator.

    Falling back to single-process is only legitimate when nothing asked
    for a multi-process run; a *configured* coordinator that fails to
    connect must raise (a silent fallback would run the job at 1/N scale
    without a word)."""
    if kwargs.get("init_method") or kwargs.get("store") is not None:
        return True
    if os.environ.get("MASTER_ADDR"):
        return True
    for k in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        v = os.environ.get(k)
        if v is not None:
            try:
                if int(v) > 1:
                    return True
            except ValueError:
                pass
    return False


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def initialize_distributed(**kwargs) -> int:
    """Multi-process entry (reference C24 -- entirely new surface).

    Wraps ``torch.distributed.init_process_group`` and returns the world
    size.  The launch comes from the keywords (``init_method``, ``rank``,
    ``world_size``, ``backend``, ``timeout``, ``store``) or from torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``).  ``device``: ``"cpu"`` runs the rank
    on the CPU; otherwise its device is ``cuda:LOCAL_RANK``, made the
    current CUDA device (so ``device=None``, the port's default, means
    it).  The backend defaults to ``nccl`` on CUDA and
    ``gloo`` on the CPU.  Idempotent: a second call returns the world size.

    Failure policy (JAX mesh.py:73-107): if a coordinator IS configured
    (an ``init_method`` or ``store``, ``MASTER_ADDR``, or a launcher's
    world size above 1), any initialization error re-raises -- a
    misconfigured multi-process launch must not silently degrade to one
    process.  Only a bare local launch (no coordinator anywhere) runs as a
    single process (a world of one, over an in-process store), and says
    so on the logger.
    """
    kwargs = dict(kwargs)
    dev = torch.device(kwargs.pop("device", None) or "cuda")
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; pass "
                               "device='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    if dist.is_initialized():
        return dist.get_world_size()
    backend = kwargs.pop("backend", None) or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = kwargs.pop("timeout", None)
    if isinstance(timeout, (int, float)):
        timeout = datetime.timedelta(seconds=float(timeout))
    configured = _coordinator_configured(kwargs)
    if configured:
        init_method = kwargs.pop("init_method", None)
        store = kwargs.pop("store", None)
        if init_method is None and store is None:
            init_method = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
        rank = int(kwargs.pop("rank", _env_int("RANK", 0)))
        world = int(kwargs.pop("world_size", _env_int("WORLD_SIZE", 1)))
        if kwargs:
            raise TypeError(f"initialize_distributed: unknown keywords {sorted(kwargs)}")
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(backend, init_method=init_method, store=store,
                                    rank=rank, world_size=world, timeout=timeout)
        except Exception as e:   # noqa: BLE001 -- every failure is re-raised
            raise RuntimeError(
                "torch.distributed initialization failed with a coordinator "
                f"configured -- refusing silent single-process fallback: {e}") from e
        _log.info("torch.distributed initialized: rank %d of %d (%s on %s)",
                  rank, world, backend, dev)
    else:
        if kwargs.pop("rank", 0) not in (0, None) or kwargs.pop("world_size", 1) not in (1, None):
            raise ValueError("initialize_distributed: a rank or world size above one "
                             "needs an init_method (or MASTER_ADDR)")
        if kwargs:
            raise TypeError(f"initialize_distributed: unknown keywords {sorted(kwargs)}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
        _log.info("no coordinator configured; running single-process (%s on %s)",
                  backend, dev)
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, axis_name: str = CHAIN_AXIS):
    """A 1-D ``DeviceMesh`` over ``n_devices`` ranks (default: the whole
    world) for chain data parallelism, named ``(axis_name,)``.

    MCMC ensembles are embarrassingly parallel along the walker axis, so a
    single ``chains`` axis is the topology; parameter and dataset axes
    stay replicated.  Initializes a single-process world first when no
    process group exists.  The mesh's device type follows the backend
    (``cuda`` under NCCL, ``cpu`` under gloo, which also carries CUDA
    tensors through host memory).
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        initialize_distributed(device="cuda" if torch.cuda.is_available() else "cpu")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} available")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))


def replicated(mesh) -> tuple:
    """The placement of a tensor every rank holds whole: ``(Replicate(),)``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def state_shardings(mesh, axis_name: str = CHAIN_AXIS) -> WalkerState:
    """Placements for :class:`WalkerState`: the walker-axis tensors shard
    along ``chains`` (``Shard(0)``); the proposal factor, the pooled
    moments, the ChEES state and the counters are replicated (identical
    on every rank after each chunk's all-reduce)."""
    from torch.distributed.tensor import Shard

    chains = (Shard(0),)
    rep = replicated(mesh)
    return WalkerState(position=chains, logprob=chains, best_position=chains,
                       best_logprob=chains, l_matrix=rep, m_sum=rep, m_outer=rep,
                       m_count=rep, age=rep, anneal_step=rep, chees=rep)


def shard_state(state: WalkerState, mesh, axis_name: str = CHAIN_AXIS) -> WalkerState:
    """This rank's share of an ensemble state: its contiguous slice of the
    walker-axis tensors (plain tensors on its device), the replicated
    fields whole.

    Requires ``W % n == 0``.  Every process builds the IDENTICAL full
    state (seeded, deterministic initialization) and keeps its rows, the
    contract of JAX's ``make_array_from_process_local_data``.
    """
    comm = chain_comm(mesh)
    W = state.position.shape[0]
    n = comm.size
    if W % n != 0:
        raise ValueError(f"n_walkers={W} must be divisible by mesh size {n}")
    wl = W // n
    mine = slice(comm.rank * wl, (comm.rank + 1) * wl)
    return WalkerState(
        position=state.position[mine].clone(), logprob=state.logprob[mine].clone(),
        best_position=state.best_position[mine].clone(),
        best_logprob=state.best_logprob[mine].clone(),
        l_matrix=state.l_matrix, m_sum=state.m_sum, m_outer=state.m_outer,
        m_count=state.m_count, age=state.age, anneal_step=state.anneal_step,
        chees=state.chees)


class ChainComm:
    """The chain axis's collectives: a process group, this rank's place in
    it, and a count of the all-reduces made (``calls``), which the chunk
    runner reports per chunk.

    Every collective is one SUM all-reduce.  Under gloo a CUDA tensor is
    staged through host memory: the transport only, the computation stays
    on the card.  NCCL reduces on the card.
    """

    def __init__(self, group, rank: int, size: int):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.backend = dist.get_backend(group)
        self.calls = 0

    def all_reduce_sum(self, t):
        """The elementwise sum of ``t`` over the ranks (a new tensor)."""
        self.calls += 1
        if self.backend == "gloo" and t.is_cuda:
            host = t.detach().to("cpu", copy=True)
            dist.all_reduce(host, group=self.group)
            return host.to(t.device)
        buf = t.detach().clone().contiguous()
        dist.all_reduce(buf, group=self.group)
        return buf

    def exchange(self, vec=None, rows=None, lo: int = 0, total: int = 0):
        """One all-reduce that does both of a chunk's exchanges.

        ``vec`` (K,): every rank's, returned stacked ``(size, K)`` in rank
        order.  ``rows`` (n, k): this rank's rows ``lo .. lo + n`` of a
        ``(total, k)`` array, returned whole.  Each rank writes its own
        entries into a zero buffer, so the sum is an exact gather.
        Returns ``(stacked or None, whole or None)``.
        """
        ref = vec if vec is not None else rows
        parts = []
        if vec is not None:
            stack = torch.zeros((self.size, vec.numel()), dtype=ref.dtype, device=ref.device)
            stack[self.rank] = vec.reshape(-1)
            parts.append(stack.reshape(-1))
        if rows is not None:
            whole = torch.zeros((total, rows.shape[1]), dtype=ref.dtype, device=ref.device)
            whole[lo:lo + rows.shape[0]] = rows
            parts.append(whole.reshape(-1))
        flat = self.all_reduce_sum(parts[0] if len(parts) == 1 else torch.cat(parts))
        out_vec = out_rows = None
        if vec is not None:
            out_vec = flat[:self.size * vec.numel()].reshape(self.size, vec.numel())
            flat = flat[self.size * vec.numel():]
        if rows is not None:
            out_rows = flat.reshape(total, rows.shape[1])
        return out_vec, out_rows


_COMMS: dict = {}


def chain_comm(mesh) -> ChainComm:
    """The :class:`ChainComm` of a ``DeviceMesh`` (its chain axis), a
    process group, or a ``ChainComm`` itself; one per mesh."""
    if isinstance(mesh, ChainComm):
        return mesh
    key = id(mesh)
    hit = _COMMS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if hasattr(mesh, "get_group"):
        group = mesh.get_group(0)
        comm = ChainComm(group, mesh.get_local_rank(0), mesh.size())
    else:
        comm = ChainComm(mesh, dist.get_rank(mesh), dist.get_world_size(mesh))
    _COMMS[key] = (mesh, comm)
    return comm


def refuse_multi_process(walker, verb: str) -> None:
    """Raise for a verb that reads the whole ensemble on one process when
    ``walker`` is sharded over more than one (ROADMAP Queue 3 lists them)."""
    mesh = getattr(walker, "mesh", None)
    if mesh is not None and chain_comm(mesh).size > 1:
        raise ValueError(
            f"{verb}: the walker is sharded over {chain_comm(mesh).size} processes, "
            f"and {verb} reads the whole ensemble in one process; it is not ported "
            "to a shard (run it before shard(), or on an unsharded fit)")
