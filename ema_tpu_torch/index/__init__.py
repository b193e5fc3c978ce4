from ema_tpu_torch.index.build import ReferenceIndex, build_index  # noqa: F401
from ema_tpu_torch.index.sharded import (  # noqa: F401
    MAX_SHARD_BASES, ShardedIndex, build_and_save_sharded,
    build_index_sharded)
