"""GPU decode kernel vs the input and the XLA scan decoder.

The CPU cases run the kernel in Pallas interpret mode at small widths;
cases marked ``gpu`` run the compiled kernel at the published widths.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from deltarice_tpu.codec import _decode_segments_scan, decode_segments
from deltarice_tpu.config import RiceConfig
from deltarice_tpu.ops.pack_pallas import BLOCK
from deltarice_tpu.ops.pack_xla import pack_bits
from deltarice_tpu.ops.prefilter import prefilter_encode
from deltarice_tpu.ops.rice import codeword_lengths_values, zigzag
from deltarice_tpu.ops.unpack_pallas import unpack_decode_pallas


def _walk(shape, sigma=10.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, sigma, shape), axis=-1)).astype(
        np.int16
    )


def _encode(x, k, pad_cols=2, filt=(1, -1), prefiltered=False):
    d = jnp.asarray(x) if prefiltered else prefilter_encode(jnp.asarray(x),
                                                           filt)
    lens, vals = codeword_lengths_values(zigzag(d), k)
    max_words = (x.shape[-1] * 25 + 31) // 32
    words, _ = pack_bits(lens, vals, max_words, "segsum")
    return jnp.pad(words, ((0, 0), (0, pad_cols)))


def _decode(words, n, k, delta=True, interpret=True):
    return np.asarray(unpack_decode_pallas(words, n, k, delta, interpret))


@pytest.mark.parametrize("k", [0, 3, 15])
def test_kernel_matches_input_all_k(k):
    x = _walk((9, 160), seed=k)
    np.testing.assert_array_equal(_decode(_encode(x, k), 160, k), x)


@pytest.mark.parametrize("k", [1, 7, 13])
def test_kernel_matches_input_remaining_k(k):
    x = _walk((9, 160), sigma=40.0, seed=k)
    np.testing.assert_array_equal(_decode(_encode(x, k), 160, k), x)


def test_kernel_escape_heavy():
    """Uniform full-range int16: nearly every codeword is an escape."""
    rng = np.random.default_rng(1)
    x = rng.integers(-32768, 32768, (5, 300)).astype(np.int16)
    np.testing.assert_array_equal(_decode(_encode(x, 3), 300, 3), x)


def test_kernel_multi_block():
    """Rows past one program (and not a multiple of it)."""
    x = _walk((3 * BLOCK + 7, 96), sigma=6.0, seed=2)
    np.testing.assert_array_equal(_decode(_encode(x, 3), 96, 3), x)


def test_kernel_vs_scan_oracle():
    x = _walk((4, 200), seed=3)
    cfg = RiceConfig(8, 200)
    words = _encode(x, cfg.k)
    b = np.asarray(_decode_segments_scan(words, 200, cfg))
    np.testing.assert_array_equal(_decode(words, 200, cfg.k), b)


@pytest.mark.parametrize("k", [0, 3, 15])
def test_kernel_every_int16_value(k):
    """All 65,536 int16 values coded directly (no delta): every zigzag
    code decodes, escapes and k-bit remainders included."""
    vals = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    x = np.random.default_rng(k).permutation(vals).reshape(32, 2048)
    words = _encode(x, k, prefiltered=True)
    np.testing.assert_array_equal(_decode(words, 2048, k, delta=False), x)


def test_kernel_generic_filter_returns_filtered_values():
    """Without the fused delta the kernel returns the filtered values;
    the codec applies the generic-FIR inverse afterwards in XLA."""
    x = _walk((4, 300), seed=4)
    cfg = RiceConfig(8, 300, (1, -2, 1))
    d = np.asarray(prefilter_encode(jnp.asarray(x), cfg.filt))
    words = _encode(x, cfg.k, filt=cfg.filt)
    np.testing.assert_array_equal(_decode(words, 300, cfg.k, False), d)
    scan = np.asarray(_decode_segments_scan(words, 300, cfg))
    np.testing.assert_array_equal(scan, x)


def test_kernel_short_rows_decode_their_prefix():
    """Rows holding fewer samples than requested (a leftover segment)
    decode their own samples exactly; the tail is don't-care."""
    x = _walk((3, 400), seed=5)
    words = np.array(_encode(x, 3))
    short = _encode(x[:, :150], 3)
    words[:, : short.shape[1]] = np.asarray(short)
    words[:, short.shape[1]:] = 0
    out = _decode(jnp.asarray(words), 400, 3)
    np.testing.assert_array_equal(out[:, :150], x[:, :150])


def test_wrapper_tiny_widths_and_empty_inputs():
    """Width-1 rows (a stream with no pad word) never read out of
    bounds; empty inputs return empty outputs of the right shape."""
    x = np.zeros((2, 10), np.int16)
    words = _encode(x, 3, pad_cols=0)[:, :1]
    np.testing.assert_array_equal(_decode(words, 10, 3), x)
    assert _decode(jnp.zeros((0, 8), jnp.uint32), 5, 3).shape == (0, 5)
    assert _decode(jnp.zeros((3, 8), jnp.uint32), 0, 3).shape == (3, 0)


def test_wrapper_output_shape_and_dtype():
    x = _walk((BLOCK + 1, 33), seed=6)
    out = unpack_decode_pallas(_encode(x, 3), 33, 3, True, True)
    assert out.shape == (BLOCK + 1, 33) and out.dtype == jnp.int16
    np.testing.assert_array_equal(np.asarray(out), x)


# --- on the card, at the published widths --------------------------------

@pytest.mark.gpu
def test_decode_segments_auto_picks_pallas():
    x = _walk((3, 128), seed=4)
    cfg = RiceConfig(8, 128)
    words = _encode(x, cfg.k)
    out = decode_segments(words, 128, cfg, backend="auto")
    np.testing.assert_array_equal(np.asarray(out), x)
    np.testing.assert_array_equal(_decode(words, 128, cfg.k, True, False), x)


@pytest.mark.gpu
@pytest.mark.parametrize("length,m", [(7000, 8), (81920, 16), (500000, 8)])
def test_compiled_kernel_matches_scan_real_width(length, m):
    """64 rows at each published segment width, compiled for the card,
    against the XLA scan decoder (exact: an integer codec)."""
    x = _walk((64, length), seed=length)
    cfg = RiceConfig(m, length)
    words = _encode(x, cfg.k)
    out = _decode(words, length, cfg.k, True, False)
    np.testing.assert_array_equal(out, x)
    if length <= 81920:  # the scan is one device loop step per sample
        np.testing.assert_array_equal(
            out, np.asarray(_decode_segments_scan(words, length, cfg)))
