"""Multi-device / multi-host parallelism for the Delta-Rice codec.

The reference's only parallelism is OpenMP threads over waveform segments
within one HDF5 chunk (``/root/reference/src/deltaRice.c:417-426,327-335``).
Here that becomes one GPU thread per segment in the device kernels, and a
new, first-class layer shards *chunks* across a ``jax.sharding.Mesh`` — the
multi-device replacement for "one filter call per chunk on the host
thread".
"""

from .sharded import (
    chunk_mesh,
    encode_chunks_sharded,
    decode_chunks_sharded,
    roundtrip_check_step,
)

__all__ = [
    "chunk_mesh",
    "encode_chunks_sharded",
    "decode_chunks_sharded",
    "roundtrip_check_step",
]
