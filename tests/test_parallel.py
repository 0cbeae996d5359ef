"""Sharded chunk-parallel encode/decode over a virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

import deltarice_tpu as drt
from deltarice_tpu.codec import frame_stream
from deltarice_tpu.parallel import (
    chunk_mesh,
    decode_chunks_sharded,
    encode_chunks_sharded,
    roundtrip_check_step,
)
from deltarice_tpu.parallel.sharded import put_sharded


def _cpu_mesh(n=8):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return chunk_mesh(devs[:n])


def _chunk_batch(nchunks=8, nseg=4, length=256, seed=0):
    rng = np.random.default_rng(seed)
    x = np.round(
        np.cumsum(rng.normal(0, 10, (nchunks, nseg, length)), axis=-1)
    ).astype(np.int16)
    nvalid = np.full((nchunks, nseg), length, dtype=np.int32)
    return x, nvalid


def test_sharded_roundtrip_no_mismatch():
    mesh = _cpu_mesh()
    cfg = drt.RiceConfig(8, 256)
    x, nvalid = _chunk_batch()
    nvalid[-1, -1] = 100  # short leftover segment on the last device
    words, nwords, mism = roundtrip_check_step(
        put_sharded(x, mesh), put_sharded(nvalid, mesh), cfg, mesh,
        cfg.max_words(256),
    )
    assert int(mism) == 0


def test_sharded_bytes_match_single_device():
    """The framed stream produced from sharded outputs must be identical to
    the single-chip compress() result, chunk by chunk."""
    mesh = _cpu_mesh()
    length = 200
    cfg = drt.RiceConfig(8, length)
    x, nvalid = _chunk_batch(nchunks=8, nseg=3, length=length, seed=7)
    words, nwords = encode_chunks_sharded(
        put_sharded(x, mesh), put_sharded(nvalid, mesh), cfg, mesh,
        cfg.max_words(length),
    )
    words = np.asarray(words)
    nwords = np.asarray(nwords)
    for c in range(x.shape[0]):
        blob = frame_stream(3 * length, words[c], nwords[c])
        assert blob == drt.compress(x[c].ravel(), cfg)


def test_sharded_decode_matches_input():
    mesh = _cpu_mesh()
    length = 128
    cfg = drt.RiceConfig(4, length)
    x, nvalid = _chunk_batch(nchunks=16, nseg=2, length=length, seed=3)
    words, nwords = encode_chunks_sharded(
        put_sharded(x, mesh), put_sharded(nvalid, mesh), cfg, mesh,
        cfg.max_words(length),
    )
    out = decode_chunks_sharded(words, length, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(out), x)


@pytest.mark.gpu
def test_sharded_kernels_on_gpu_mesh():
    """A GPU mesh runs the kernels inside shard_map."""
    mesh = chunk_mesh(jax.devices("gpu"))
    cfg = drt.RiceConfig(8, 256)
    nchunks = 2 * len(jax.devices("gpu"))
    x, nvalid = _chunk_batch(nchunks=nchunks, nseg=4, length=256, seed=9)
    words, nwords, mism = roundtrip_check_step(
        put_sharded(x, mesh), put_sharded(nvalid, mesh), cfg, mesh,
        cfg.max_words(256),
    )
    assert int(mism) == 0
    # bytes equal the host codec's
    blob = frame_stream(4 * 256, np.asarray(words)[0], np.asarray(nwords)[0])
    assert blob == drt.compress(x[0].ravel(), cfg)
