"""Multi-device execution — the port of gms_tpu/parallel/ (sharding.py's
edge-sharded triangle count and multi.py), on torch.distributed: each rank
is one shard, as each device is one shard of gms_tpu's shard_map, and psum
becomes an all_reduce."""
