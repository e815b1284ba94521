"""Multi-device training (counterpart of `agacs_tpu/parallel/`): the mesh,
the sharding rules and the collectives (`mesh.py`), the whisper family's
tensor parallelism (`tensor_parallel.py`) and ZeRO-1 (`zero.py`)."""

from agacs_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    opt_state_shard_stats,
    param_sharding_rules,
    shard_batch,
    shard_opt_state,
    shard_params,
)
