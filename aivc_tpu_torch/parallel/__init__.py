from aivc_tpu_torch.parallel.mesh import (  # noqa: F401
    frame_sharding,
    make_mesh,
    replicated,
    shard_params,
    stacked_frame_sharding,
)
