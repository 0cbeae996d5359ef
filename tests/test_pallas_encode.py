"""GPU encode kernel vs the XLA packer and the native C codec.

The CPU cases run the kernel in Pallas interpret mode at small widths;
cases marked ``gpu`` run the compiled kernel at the published widths.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import deltarice_tpu as drt
from deltarice_tpu.codec import (
    _encode_segments_xla,
    _split_layout,
    encode_segments,
    frame_stream,
    merge_substreams,
)
from deltarice_tpu.config import RiceConfig
from deltarice_tpu.native import native_compress
from deltarice_tpu.ops.pack_pallas import BLOCK, launch_shape, pack_encode_pallas
from deltarice_tpu.ops.prefilter import prefilter_encode


def _walk(shape, sigma=10.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, sigma, shape), axis=-1)).astype(
        np.int16
    )


def _kernel(x, nvalid, cfg, mw=None, interpret=True, prev0=None):
    mw = mw or cfg.max_words(x.shape[1])
    xj = jnp.asarray(x)
    if not cfg.is_delta:
        xj = prefilter_encode(xj, cfg.filt)
    p0 = None if prev0 is None else jnp.asarray(prev0)
    return pack_encode_pallas(xj, jnp.asarray(nvalid), cfg.k, mw,
                              cfg.is_delta, p0, interpret)


def _compare(x, nvalid, cfg, interpret=True):
    mw = cfg.max_words(x.shape[1])
    w_k, n_k, b_k = _kernel(x, nvalid, cfg, mw, interpret)
    w_x, n_x, b_x = _encode_segments_xla(jnp.asarray(x), jnp.asarray(nvalid),
                                         cfg, mw, "segsum")
    np.testing.assert_array_equal(np.asarray(n_k), np.asarray(n_x))
    np.testing.assert_array_equal(np.asarray(b_k), np.asarray(b_x))
    np.testing.assert_array_equal(np.asarray(w_k), np.asarray(w_x))
    return np.asarray(w_k), np.asarray(n_k)


@pytest.mark.parametrize("k", [0, 1, 3, 7, 13, 15])
def test_kernel_matches_xla_all_k(k):
    x = _walk((9, 300), seed=k)
    _compare(x, np.full(9, 300, np.int32), RiceConfig(1 << k, 300))


def test_kernel_escape_heavy():
    rng = np.random.default_rng(1)
    x = rng.integers(-32768, 32768, (5, 700)).astype(np.int16)
    _compare(x, np.full(5, 700, np.int32), RiceConfig(8, 700))


def test_kernel_short_segments():
    x = _walk((6, 520), sigma=8.0, seed=2)
    nv = np.array([520, 1, 100, 0, 519, 512], np.int32)
    x[nv[:, None] <= np.arange(520)[None, :]] = 0  # padded like the codec
    _compare(x, nv, RiceConfig(8, 520))


def test_kernel_multi_block():
    """Rows past one program (and not a multiple of it) exercise the grid
    and the last program's masked threads."""
    x = _walk((3 * BLOCK + 5, 96), seed=3)
    _compare(x, np.full(x.shape[0], 96, np.int32), RiceConfig(8, 96))


def test_kernel_generic_filter():
    x = _walk((4, 200), seed=4)
    _compare(x, np.full(4, 200, np.int32), RiceConfig(8, 200, (1, -2, 1)))


def test_roundtrip_through_both_kernels():
    """Kernel encode -> kernel decode reproduces the input; the framed
    bytes equal the native C codec's."""
    from deltarice_tpu.ops.unpack_pallas import unpack_decode_pallas

    x = _walk((7, 100), seed=5)
    cfg = RiceConfig(8, 100)
    w, nw = _compare(x, np.full(7, 100, np.int32), cfg)
    blob = frame_stream(x.size, w, nw)
    assert blob == native_compress(x, cfg.to_cd_values())
    wd = np.pad(w[:, : int(nw.max())], ((0, 0), (0, 1)))
    out = unpack_decode_pallas(jnp.asarray(wd), 100, cfg.k, True, True)
    np.testing.assert_array_equal(np.asarray(out), x)


@pytest.mark.parametrize("k", [0, 3, 15])
def test_kernel_every_int16_value(k):
    """All 65,536 int16 values as pre-filtered inputs: every zigzag code,
    escapes and k-bit remainders included, against the XLA packer."""
    vals = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    x = np.random.default_rng(k).permutation(vals).reshape(32, 2048)
    cfg = RiceConfig(1 << k, 2048)
    mw = cfg.max_words(2048)
    nv = jnp.full(32, 2048, jnp.int32)
    w_k, n_k, _ = pack_encode_pallas(jnp.asarray(x), nv, k, mw, False, None,
                                     True)
    w_x, n_x, _ = _encode_segments_xla(jnp.asarray(x), nv, cfg, mw, "segsum",
                                       None, True)
    np.testing.assert_array_equal(np.asarray(n_k), np.asarray(n_x))
    np.testing.assert_array_equal(np.asarray(w_k), np.asarray(w_x))


def test_kernel_every_int16_delta():
    """Every int16 value through the fused delta path (wrapping
    differences of a permutation) matches the native C codec."""
    vals = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    x = np.random.default_rng(9).permutation(vals).reshape(16, 4096)
    cfg = RiceConfig(8, 4096)
    w, nw = _compare(x, np.full(16, 4096, np.int32), cfg)
    assert frame_stream(x.size, w, nw) == native_compress(
        x, cfg.to_cd_values())


def test_kernel_prev0_split_equals_serial():
    """Sub-block split with delta seeds: merged kernel sub-streams are
    byte-identical to the serial stream (the split-encode contract)."""
    x = _walk((3, 3000), seed=6)
    cfg = RiceConfig(8, 3000)
    nv = np.array([3000, 3000, 2100], np.int32)
    x[2, 2100:] = 0
    xs, nvs, p0, ls = _split_layout(x, nv, 4)
    w, nw, nb = _kernel(xs, nvs, cfg, cfg.max_words(ls), True, p0)
    wmax = max(int(np.asarray(nw).max()), 1)
    merged, mnw = merge_substreams(
        np.asarray(w)[:, :wmax].reshape(3, 4, wmax),
        np.asarray(nb).reshape(3, 4),
    )
    w_x, n_x, _ = _encode_segments_xla(jnp.asarray(x), jnp.asarray(nv), cfg,
                                       cfg.max_words(3000), "segsum")
    np.testing.assert_array_equal(mnw, np.asarray(n_x))
    np.testing.assert_array_equal(merged,
                                  np.asarray(w_x)[:, : merged.shape[1]])


def test_kernel_leftover_segment_matches_native():
    """A chunk whose last segment is short (the leftover) frames to the
    native codec's bytes."""
    x = _walk((1, 1150), seed=7).ravel()
    cfg = RiceConfig(4, 400)
    nseg, length, leftover = cfg.segments(x.size)
    padded = np.zeros((nseg, length), np.int16)
    padded.ravel()[: x.size] = x
    nv = np.full(nseg, length, np.int32)
    nv[-1] = leftover
    w, nw = _compare(padded, nv, cfg)
    assert frame_stream(x.size, w, nw) == native_compress(
        x, cfg.to_cd_values())


def test_wrapper_zero_past_stream_and_wide_output():
    """Output wider than the worst case stays zero past every stream."""
    x = _walk((5, 64), seed=8)
    cfg = RiceConfig(8, 64)
    w, nw, _ = _kernel(x, np.full(5, 64, np.int32), cfg,
                       cfg.max_words(64) + 40)
    w, nw = np.asarray(w), np.asarray(nw)
    assert w.shape == (5, cfg.max_words(64) + 40)
    for r in range(5):
        assert not w[r, nw[r]:].any()


def test_wrapper_shapes_and_launch():
    assert launch_shape(1) == (1, BLOCK)
    assert launch_shape(BLOCK) == (1, BLOCK)
    assert launch_shape(BLOCK + 1) == (2, 2 * BLOCK)
    w, nw, nb = pack_encode_pallas(jnp.zeros((0, 16), jnp.int16),
                                   jnp.zeros((0,), jnp.int32), 3, 10, True,
                                   None, True)
    assert w.shape == (0, 10) and nw.shape == (0,) and nb.shape == (0,)
    w, nw, nb = pack_encode_pallas(jnp.zeros((3, 16), jnp.int16),
                                   jnp.zeros((3,), jnp.int32), 3, 10, True,
                                   None, True)
    assert not np.asarray(w).any() and not np.asarray(nw).any()


# --- on the card, at the published widths --------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("length,m", [(7000, 8), (81920, 16), (15625, 8)])
def test_compiled_kernel_matches_xla_real_width(length, m):
    """64 rows at each published segment width (NOPTREX encodes as
    15625-sample sub-blocks), compiled for the card."""
    x = _walk((64, length), seed=length)
    _compare(x, np.full(64, length, np.int32), RiceConfig(m, length), False)


@pytest.mark.gpu
def test_compiled_roundtrip_matches_native():
    x = _walk((32, 7000), seed=11)
    cfg = RiceConfig(8, 7000)
    blob = drt.compress(x, cfg, method="pallas")
    assert blob == native_compress(x, cfg.to_cd_values())
    assert blob == drt.compress(x, cfg, method="segsum")
    np.testing.assert_array_equal(
        drt.decompress(blob, cfg, backend="pallas").reshape(x.shape), x)


@pytest.mark.gpu
def test_compiled_split_encode_matches_native():
    x = _walk((2, 70000), sigma=8.0, seed=12)
    cfg = RiceConfig(8, 70000)
    blob = drt.compress(x, cfg)
    assert blob == native_compress(x, cfg.to_cd_values())


@pytest.mark.gpu
def test_encode_segments_auto_picks_kernel():
    x = _walk((8, 256), seed=13)
    cfg = RiceConfig(8, 256)
    nv = jnp.full(8, 256, jnp.int32)
    w_a, n_a = encode_segments(jnp.asarray(x), nv, cfg, cfg.max_words(256))
    w_k, n_k, _ = pack_encode_pallas(jnp.asarray(x), nv, 3,
                                     cfg.max_words(256))
    np.testing.assert_array_equal(np.asarray(w_a), np.asarray(w_k))
    np.testing.assert_array_equal(np.asarray(n_a), np.asarray(n_k))
