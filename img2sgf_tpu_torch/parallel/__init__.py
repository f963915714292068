from .feed import feed_and_detect, local_file_slice, make_global_batch
from .mesh import aggregate_metrics, data_devices, make_sharded_detector, shard_batch

__all__ = [
    "aggregate_metrics",
    "data_devices",
    "feed_and_detect",
    "local_file_slice",
    "make_global_batch",
    "make_sharded_detector",
    "shard_batch",
]
