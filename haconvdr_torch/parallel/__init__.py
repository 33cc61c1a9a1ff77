from haconvdr_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    group_max,
    group_sum,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from haconvdr_torch.parallel.sharded_search import ShardedIndex, sharded_topk  # noqa: F401
from haconvdr_torch.parallel.sharded_encode import (  # noqa: F401
    dp_encode_fn,
    encode_batches,
    encoder_param_pspecs,
    shard_params,
)
