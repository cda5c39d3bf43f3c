"""Data parallelism over the agent axis (counterpart of
``visfly_tpu/parallel``); see ``mesh.py``."""
from .mesh import (
    Mesh,
    all_reduce_,
    all_reduce_grads_,
    dryrun_multichip,
    gather_rows,
    make_mesh,
    make_rank_env,
    replicate_pytree,
    rows_of,
    run_ranks,
    shard_batch_pytree,
    shard_train_state,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "rows_of",
    "make_rank_env",
    "all_reduce_",
    "all_reduce_grads_",
    "gather_rows",
    "shard_batch_pytree",
    "replicate_pytree",
    "shard_train_state",
    "run_ranks",
    "dryrun_multichip",
]
