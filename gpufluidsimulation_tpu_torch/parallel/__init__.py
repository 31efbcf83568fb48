from gpufluidsimulation_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    shard_state,
    sharded_step,
)
