"""Multi-card data parallelism over torch.distributed: process groups,
row-sharded batch encode, ordered concatenation by an all-gather of
byte counts, and the checksum registers combined on the host.

Port of `libdeflate_rsx_tpu/parallel/`: a JAX mesh axis becomes a
process group, one rank per card (`shard.py`); the multi-host helpers
become multi-rank ones (`multihost.py`); `entry.py` holds the port's
`entry()` and `dryrun_multichip(n)`.
"""

from .shard import (AXIS, ShardedCompressor, ShardedDecompressor,
                    shard_blocks, stream_mesh)

__all__ = ["AXIS", "ShardedCompressor", "ShardedDecompressor",
           "shard_blocks", "stream_mesh"]
