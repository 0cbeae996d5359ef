"""Sub-block-split encoding of long waveforms.

Long segments split into P sub-blocks, one encode thread each (delta
state seeded with the predecessor's last sample), whose packed
sub-streams merge at bit offsets — byte-identical to the serial pass by
construction. These tests pin that equivalence on the XLA path (any
backend); the GPU-kernel variant is in ``test_pallas_encode.py``.
The reference's parallelism stops at whole waveforms
(``/root/reference/src/deltaRice.c:417-426``).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

import deltarice_tpu as drt
from deltarice_tpu.codec import (
    _split_layout,
    _split_parts,
    encode_segments,
    frame_stream,
    merge_substreams,
)
from deltarice_tpu.config import RiceConfig


def _serial_blob(x, cfg):
    nseg, length = x.shape
    nvalid = np.full(nseg, length, np.int32)
    w, nw = encode_segments(
        jnp.asarray(x), jnp.asarray(nvalid), cfg, cfg.max_words(length),
        "segsum",
    )
    return frame_stream(nseg * length, np.asarray(w), np.asarray(nw))


@pytest.mark.parametrize(
    "nseg,length,m,sigma",
    [
        (3, 70000, 8, 8.0),       # NOPTREX-like long segments
        (2, 100001, 16, 30.0),    # odd length, nEDM-like M
        (1, 40000, 8, 2000.0),    # escape-heavy single segment
    ],
)
@pytest.mark.slow
def test_split_encode_byte_identical(nseg, length, m, sigma):
    rng = np.random.default_rng(nseg * length)
    x = np.round(
        np.cumsum(rng.normal(0, sigma, (nseg, length)), axis=-1)
    ).astype(np.int16)
    cfg = RiceConfig(m, length)
    assert _split_parts(nseg, length, cfg) > 1
    blob = drt.compress(x, cfg, method="segsum")
    assert blob == _serial_blob(x, cfg)
    rt = drt.decompress(blob, cfg, backend="scan")
    np.testing.assert_array_equal(rt.reshape(nseg, length), x)


@pytest.mark.slow
@pytest.mark.parametrize("filt", [(1, -1), (1, -2, 1), (2, 1)])
def test_split_generic_filter_byte_identical(filt):
    """FIR split: each sub-block filters over a halo of preceding raw
    samples, reproducing the serial filter outputs exactly."""
    rng = np.random.default_rng(11)
    x = np.round(
        np.cumsum(rng.normal(0, 6, (2, 50000)), axis=-1)
    ).astype(np.int16)
    cfg = RiceConfig(8, 50000, filt)
    assert _split_parts(2, 50000, cfg) > 1
    blob = drt.compress(x, cfg, method="segsum")
    assert blob == _serial_blob(x, cfg)


@pytest.mark.slow
def test_split_leftover_segment_matches_reference_oracle():
    rng = np.random.default_rng(5)
    x = np.round(np.cumsum(rng.normal(0, 8, 150000), axis=-1)).astype(
        np.int16
    )
    cfg = RiceConfig(8, 70000)  # two full segments + 10000 leftover
    blob = drt.compress(x, cfg, method="segsum")
    from deltarice_tpu.testing.oracle import ReferenceOracle

    assert blob == ReferenceOracle().compress(x, cfg.to_cd_values())
    np.testing.assert_array_equal(drt.decompress(blob, cfg, "scan"), x)


def test_split_parts_policy():
    delta = RiceConfig(8, -1)
    assert _split_parts(1024, 7000, delta) == 1            # short: no split
    assert _split_parts(256, 500000, delta) == 16          # NOPTREX
    assert _split_parts(1024, 81920, delta) == 4           # nEDM -> packed
    fir = RiceConfig(8, -1, (1, -2, 1))
    assert _split_parts(256, 500000, fir) == 16            # FIR splits too


@pytest.mark.parametrize("use_native", [True, False])
def test_merge_substreams_numpy_vs_native(use_native, monkeypatch):
    if not use_native:  # force the numpy fallback
        from deltarice_tpu import native

        monkeypatch.setattr(native, "_codec_lib", None)
    rng = np.random.default_rng(7)
    rows, parts, w_in = 5, 4, 9
    words = rng.integers(0, 2**32, (rows, parts, w_in)).astype(np.uint32)
    nbits = rng.integers(0, w_in * 32 + 1, (rows, parts)).astype(np.int64)
    # zero-fill beyond each stream's bits, as the packer guarantees
    for s in range(rows):
        for p in range(parts):
            nb = int(nbits[s, p])
            m = (nb + 31) >> 5
            words[s, p, m:] = 0
            if nb & 31:
                words[s, p, m - 1] &= np.uint32(
                    (0xFFFFFFFF << (32 - (nb & 31))) & 0xFFFFFFFF
                )
    from deltarice_tpu import native

    got, nw = merge_substreams(words, nbits)
    # independent bit-level model
    for s in range(rows):
        bits = []
        for p in range(parts):
            nb = int(nbits[s, p])
            rowbits = np.unpackbits(
                words[s, p].astype(">u4").view(np.uint8)
            )[:nb]
            bits.append(rowbits)
        allbits = np.concatenate(bits) if bits else np.zeros(0, np.uint8)
        padded = np.pad(allbits, (0, (-len(allbits)) % 32))
        want = np.packbits(padded).view(">u4").astype(np.uint32)
        assert nw[s] == len(want)
        np.testing.assert_array_equal(got[s, : len(want)], want)
        assert not got[s, len(want):].any()
