from haconvdr_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from haconvdr_torch.parallel.sharded_search import ShardedIndex, sharded_topk  # noqa: F401
from haconvdr_torch.parallel.sharded_encode import dp_encode_fn, encode_batches  # noqa: F401
