"""Multi-host chunk pipeline.

The reference has no distributed story (OpenMP only; MPI-HDF5 explicitly
unsupported). Here multi-host scaling is pure data parallelism: every host
feeds its local shard of the chunk batch to the global mesh, the codec runs
with zero inter-chip communication (chunks are independent bitstreams by
format), and the only collective is the gather of (compressed words, word
counts) to the writer host, in file order.

Single-process usage works unchanged (the "gather" is a no-op view); under
``jax.distributed`` the same code runs SPMD on every host.
"""

from __future__ import annotations

import os

import numpy as np

import jax

from ..config import RiceConfig
from ..codec import (
    _WORD_BUCKET,
    _segment_layout,
    frame_stream,
    gather_segments,
    walk_headers,
)
from .sharded import (
    CHUNK_AXIS,
    chunk_mesh,
    decode_chunks_sharded,
    encode_chunks_sharded,
    put_sharded,
)


def initialize_distributed(**kwargs) -> None:
    """``jax.distributed.initialize`` passthrough (idempotent).

    With explicit ``kwargs`` (coordinator_address, num_processes,
    process_id, ...) any initialization failure propagates — a
    misconfigured cluster must not silently fall back to single-process.
    Without kwargs, initialization runs whenever a recognized multi-process
    launch environment is present (explicit coordinator env vars or SLURM —
    the environments ``jax.distributed.initialize`` can auto-detect); a
    failure there also propagates, because running such a
    cluster uninitialized would silently return per-host partial results.
    On a plain single-process host this is a no-op.
    """
    if jax.distributed.is_initialized():
        return
    if kwargs:
        jax.distributed.initialize(**kwargs)
        return
    cluster_env = (
        # explicit coordinator
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
        # SLURM multi-task launches (auto-detected by jax.distributed)
        "SLURM_JOB_ID",
    )
    if any(os.environ.get(v) for v in cluster_env):
        # single-task SLURM allocations are common for 1-host jobs; those
        # initialize fine (num_processes == 1), so no special-casing
        jax.distributed.initialize()


def encode_chunks_multihost(batch: np.ndarray, cfg: RiceConfig,
                            mesh=None) -> list[bytes] | None:
    """Encode a (num_chunks, segments, L) batch across all hosts' devices
    and return the framed per-chunk byte streams on process 0 (None on
    other processes).

    ``batch`` is the GLOBAL batch; every process must pass the same shapes
    (the values only need to be correct for its own shard when running
    multi-process with ``jax.make_array_from_process_local_data``-style
    feeding; single-process callers just pass the whole array).
    """
    mesh = mesh or chunk_mesh()
    nchunks, nseg, length = batch.shape
    ndev = mesh.devices.size
    pad = (-nchunks) % ndev
    if pad:
        batch = np.concatenate(
            [batch, np.zeros((pad, nseg, length), batch.dtype)], axis=0
        )
    nvalid = np.full((batch.shape[0], nseg), length, dtype=np.int32)

    words, nwords = encode_chunks_sharded(
        put_sharded(batch, mesh), put_sharded(nvalid, mesh), cfg, mesh,
        cfg.max_words(length),
    )

    # gather to the writer: fully-addressable single-process arrays convert
    # directly; multi-process needs a process-level allgather. The (tiny)
    # word counts gather first so the word gather moves ~compressed-size
    # data, not the 25-bit worst-case padding.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        nwords = multihost_utils.process_allgather(nwords, tiled=True)
        w = max(int(nwords.max(initial=0)), 1)
        words = multihost_utils.process_allgather(
            words[:, :, :w], tiled=True
        )
        if jax.process_index() != 0:
            return None
    else:
        nwords = np.asarray(nwords)
        w = max(int(nwords.max(initial=0)), 1)
        words = np.asarray(words[:, :, :w])
    total = nseg * length
    return [
        frame_stream(total, words[c], nwords[c]) for c in range(nchunks)
    ]


def decode_chunks_multihost(streams, cfg: RiceConfig,
                            mesh=None) -> np.ndarray | None:
    """Decode per-chunk framed byte streams across all hosts' devices — the
    read-side counterpart of :func:`encode_chunks_multihost` (the reference
    read path, ``/root/reference/src/deltaRice.c:301-358``, across hosts).

    Every process passes the same ``streams`` list (direct-chunk reads are
    host-cheap, so each host reads the full blob list; the device work is
    what shards). The header walk and ragged→padded segment gather run on
    the host, the decode fans out over the global mesh, and the decoded
    samples gather to process 0: returns ``(num_chunks, total_samples)``
    int16 there, ``None`` on other processes (single-process: always the
    array).
    """
    mesh = mesh or chunk_mesh()
    streams = list(streams)
    if not streams:
        return np.zeros((0, 0), dtype=np.int16)
    bufs = [np.frombuffer(memoryview(s), dtype="<u4") for s in streams]
    if any(b.size == 0 for b in bufs):
        raise ValueError("truncated Delta-Rice stream")
    total = int(bufs[0][0])
    if any(int(b[0]) != total for b in bufs):
        raise ValueError("multihost decode requires equal-sized chunks")
    nseg, length, _ = _segment_layout(total, cfg)
    per_chunk = [walk_headers(buf, nseg) for buf in bufs]
    maxw = max(int(c.max(initial=0)) for c, _ in per_chunk)
    bucket = -(-(maxw + 1) // _WORD_BUCKET) * _WORD_BUCKET
    nchunks = len(bufs)
    ndev = mesh.devices.size
    pad = (-nchunks) % ndev
    words = np.zeros((nchunks + pad, nseg, bucket), dtype=np.uint32)
    for i, (buf, (counts, starts)) in enumerate(zip(bufs, per_chunk)):
        words[i] = gather_segments(buf, counts, starts, bucket)
    out = decode_chunks_sharded(put_sharded(words, mesh), length, cfg, mesh)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        out = multihost_utils.process_allgather(out, tiled=True)
        if jax.process_index() != 0:
            return None
    out = np.asarray(out).reshape(nchunks + pad, nseg * length)
    return out[:nchunks, :total]
