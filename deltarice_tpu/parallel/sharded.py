"""Chunk-level data parallelism over a ``jax.sharding.Mesh``.

Each HDF5 chunk is an independent bitstream (the format guarantees it:
``writeWholeCompressedByteString`` frames every chunk standalone,
``/root/reference/src/deltaRice.c:383-465``), so the natural multi-device
scaling strategy is pure data parallelism: a batch of chunks shards across
the ``"chunks"`` mesh axis, every device encodes/decodes its local chunks
with the same kernels used on one device, and no collective is needed until
the host gathers compressed bytes for the file writer.

Within a device, the reference's OpenMP ``parallel for`` over waveform
segments (``src/deltaRice.c:417-426``) is one GPU thread per segment (or
the vectorized segment axis of the XLA path) — so the two parallelism
levels compose as ``(chunks-on-mesh, segments-on-threads)``. The path is
chosen from the mesh's device platform by
:func:`deltarice_tpu.backend.resolve`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import platform_of, resolve
from ..codec import decode_segments, encode_segments
from ..config import RiceConfig

CHUNK_AXIS = "chunks"


def chunk_mesh(devices=None, axis_name: str = CHUNK_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices, chunk-data-parallel."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _encode_local(x, nvalid, cfg: RiceConfig, max_words: int, method: str):
    """Encode a local (C, S, L) batch of chunks with the single-device path
    (:func:`deltarice_tpu.codec.encode_segments`); ``method`` is already
    resolved from the mesh's platform."""
    c, s, length = x.shape
    words, nwords = encode_segments(x.reshape(c * s, length),
                                    nvalid.reshape(-1), cfg, max_words,
                                    method)
    return words.reshape(c, s, max_words), nwords.reshape(c, s)


def _decode_local(words, n_samples: int, cfg: RiceConfig, backend: str):
    """Decode a local (C, S, W) batch with the single-device path;
    ``backend`` is already resolved."""
    c, s, w = words.shape
    out = decode_segments(words.reshape(c * s, w), n_samples, cfg, backend)
    return out.reshape(c, s, n_samples)


@functools.partial(
    jax.jit, static_argnames=("cfg", "max_words", "method", "axis_name", "mesh")
)
def encode_chunks_sharded(
    batch: jnp.ndarray,
    nvalid: jnp.ndarray,
    cfg: RiceConfig,
    mesh: Mesh,
    max_words: int,
    method: str = "auto",
    axis_name: str = CHUNK_AXIS,
):
    """Encode a (num_chunks, segments, L) int16 batch sharded over the mesh.

    ``num_chunks`` must divide evenly over the mesh axis (pad with empty
    chunks — ``nvalid == 0`` — to round up). Returns sharded
    ``words (C, S, max_words)`` and ``nwords (C, S)``.
    """
    method = resolve(method, "segsum", platform_of(mesh.devices))
    spec = P(axis_name)
    fn = jax.shard_map(
        lambda x, nv: _encode_local(x, nv, cfg, max_words, method),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return fn(batch, nvalid)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_samples", "axis_name", "mesh", "backend"),
)
def decode_chunks_sharded(
    words: jnp.ndarray,
    n_samples: int,
    cfg: RiceConfig,
    mesh: Mesh,
    axis_name: str = CHUNK_AXIS,
    backend: str = "auto",
):
    """Decode a (num_chunks, segments, W) uint32 batch sharded over the
    mesh; returns sharded (num_chunks, segments, n_samples) int16."""
    backend = resolve(backend, "scan", platform_of(mesh.devices))
    spec = P(axis_name)
    fn = jax.shard_map(
        lambda w: _decode_local(w, n_samples, cfg, backend),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        check_vma=False,
    )
    return fn(words)


@functools.partial(
    jax.jit, static_argnames=("cfg", "max_words", "axis_name", "mesh")
)
def roundtrip_check_step(
    batch: jnp.ndarray,
    nvalid: jnp.ndarray,
    cfg: RiceConfig,
    mesh: Mesh,
    max_words: int,
    axis_name: str = CHUNK_AXIS,
):
    """Full sharded encode → decode → verify step (the codec's analog of a
    "training step" for multi-chip validation).

    Returns (words, nwords, mismatches) where ``mismatches`` is the global
    count of samples that failed to round-trip (psum over the mesh).
    """
    spec = P(axis_name)

    platform = platform_of(mesh.devices)
    be = resolve("auto", "segsum", platform)
    bd = resolve("auto", "scan", platform)

    def local(x, nv):
        words, nwords = _encode_local(x, nv, cfg, max_words, be)
        out = _decode_local(words, x.shape[-1], cfg, bd)
        mask = (
            jnp.arange(x.shape[-1], dtype=jnp.int32)[None, None, :]
            < nv[..., None]
        )
        bad = jnp.sum(jnp.where(mask, out != x, False).astype(jnp.int32))
        return words, nwords, jax.lax.psum(bad, axis_name)

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec, P()),
        check_vma=False,
    )
    return fn(batch, nvalid)


def put_sharded(batch: np.ndarray, mesh: Mesh, axis_name: str = CHUNK_AXIS):
    """Device-put a host chunk batch with the leading axis sharded."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(batch, sharding)
