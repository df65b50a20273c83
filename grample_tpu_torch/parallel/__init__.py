from grample_tpu_torch.parallel.mesh import (  # noqa: F401
    CHAIN_AXIS,
    VARIANT_AXIS,
    ChainMesh,
    ShardedChainGroup,
    chain_mesh,
    shard_seed,
)
