"""deltarice-tpu: a GPU-accelerated Delta-Rice lossless codec for int16
waveform data (JAX / XLA / Pallas), bitstream-compatible with HDF5 filter
32025.

Capability-equivalent rebuild of david-mathews-1994/deltarice: the codec
math runs as batched device programs (GPU kernels, or plain XLA on the
CPU), the HDF5 integration uses direct-chunk I/O plus a native C filter
plugin for interop with non-JAX applications.
"""

# The persistent compilation cache makes every later process start warm.
# It is enabled lazily by the codec entry points (not at import time, so
# importing this package never mutates host-application JAX config). Opt
# out with DELTARICE_TPU_CACHE=0, or call it eagerly yourself:
from .utils.cache import enable_persistent_cache
from .utils.warmup import warmup

from .config import H5FILTER, RiceConfig, rice_k
from .codec import (
    compress,
    decompress,
    encode_segments,
    decode_segments,
)

__version__ = "0.1.0"

__all__ = [
    "H5FILTER",
    "RiceConfig",
    "enable_persistent_cache",
    "rice_k",
    "compress",
    "decompress",
    "encode_segments",
    "decode_segments",
    "warmup",
]
