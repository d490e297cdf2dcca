"""Chain-axis data parallelism on ``torch.distributed`` (JAX
``lisp_mcmc_tpu.parallel``): one process per GPU, each holding a
contiguous slice of the walkers; see :mod:`.mesh`."""

from .mesh import (
    CHAIN_AXIS,
    ChainComm,
    chain_comm,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_state,
    state_shardings,
)

__all__ = [
    "CHAIN_AXIS",
    "ChainComm",
    "chain_comm",
    "initialize_distributed",
    "make_mesh",
    "replicated",
    "shard_state",
    "state_shardings",
]
