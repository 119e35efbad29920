"""Parallelism over torch.distributed (port of vla_rft_tpu/parallel/): the
(dp, fsdp, tp, sp) mesh, FSDP placement and the trainers' data ranks
(`mesh`), process-group start-up and the collectives (`distributed`),
tensor parallelism (`tp`), Ulysses sequence parallelism (`ulysses`) and
the GPipe pipeline (`pp`)."""
from vla_rft_tpu_torch.parallel.mesh import (  # noqa: F401
    DataRanks,
    MeshConfig,
    data_rank,
    make_mesh,
    shard_batch,
    shard_params_fsdp,
)
