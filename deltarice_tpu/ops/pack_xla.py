"""MSB-first bitstream packing/unpacking as pure-XLA ops.

The packer turns per-sample Rice codewords (value, bit-length) into the
reference's uint32 word stream (``compressWithRiceCoding``,
``/root/reference/src/deltaRice.c:191-244``): codewords are laid end-to-end
MSB-first; the final partial word is zero-padded at the low end (``:237-241``).

Data-parallel design: instead of the reference's sequential 64-bit accumulator,
the bit offset of every codeword is a parallel prefix-sum of lengths; each
codeword then contributes to exactly two adjacent words (all codewords are
<= 32 bits, so a codeword starting at bit offset ``o`` in word ``w`` ends
before word ``w+2``). Because every bit belongs to exactly one codeword,
contributions to a word are disjoint bit patterns and OR == ADD, so packing
reduces to a *segment sum* over sorted word indices. Two interchangeable
lowerings are provided:

* ``segsum``: cumulative sums of the per-word contributions gathered at
  segment boundaries found by vectorized binary search (no scatter at all).
* ``scatter``: a direct dual scatter-add (simpler; XLA scatter lowering).

The unpacker is the inverse bit cursor walk (``decompressWithRiceCoding``,
``:138-189``): intra-segment decode is inherently serial (each codeword's
position depends on all previous lengths), so it runs as a ``lax.scan`` over
samples with all segments advancing in lockstep — parallelism comes from the
segment axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import ESCAPE_LEN, ESCAPE_Q

_U32 = jnp.uint32


def _contributions(lens: jnp.ndarray, vals: jnp.ndarray):
    """Split each codeword into its two word-aligned uint32 contributions.

    Returns (w0, hi, lo, nbits): codeword i ORs ``hi`` into word ``w0`` and
    ``lo`` into word ``w0 + 1``.
    """
    lens = lens.astype(jnp.int32)
    vals = jnp.where(lens > 0, vals, 0).astype(_U32)
    ends = jnp.cumsum(lens, axis=-1)
    starts = ends - lens
    nbits = ends[..., -1]
    off = starts & 31
    sh = 32 - off - lens
    hi = jnp.where(
        sh >= 0,
        vals << jnp.clip(sh, 0, 31).astype(_U32),
        vals >> jnp.clip(-sh, 0, 31).astype(_U32),
    )
    lo = jnp.where(sh >= 0, _U32(0), vals << jnp.clip(32 + sh, 0, 31).astype(_U32))
    return starts >> 5, hi, lo, nbits


def _pack_segsum(w0, hi, lo, max_words):
    """Scatter-free packing: prefix sums + boundary gather.

    ``w0`` is non-decreasing and increments by at most 1 per sample (codeword
    <= 32 bits), so word ``w``'s contributions are a contiguous sample range;
    with ``B[w] = last sample whose codeword starts in word <= w``,
    ``word[w] = Shi[B[w]] - Shi[B[w-1]] + Slo[B[w-1]] - Slo[B[w-2]]``.
    """
    shi = jnp.pad(jnp.cumsum(hi, axis=-1), ((0, 0), (1, 0)))
    slo = jnp.pad(jnp.cumsum(lo, axis=-1), ((0, 0), (1, 0)))
    wq = jnp.arange(max_words, dtype=w0.dtype)
    b = jax.vmap(lambda a: jnp.searchsorted(a, wq, side="right"))(w0)
    bm1 = jnp.pad(b[:, :-1], ((0, 0), (1, 0)))
    bm2 = jnp.pad(b[:, :-2], ((0, 0), (2, 0)))
    take = lambda s, i: jnp.take_along_axis(s, i, axis=-1)
    return take(shi, b) - take(shi, bm1) + take(slo, bm1) - take(slo, bm2)


def _pack_scatter(w0, hi, lo, max_words):
    nw = w0.shape[0]
    words = jnp.zeros((nw, max_words + 1), dtype=_U32)
    rows = jnp.broadcast_to(jnp.arange(nw)[:, None], w0.shape)
    words = words.at[rows, w0].add(hi, mode="drop")
    words = words.at[rows, w0 + 1].add(lo, mode="drop")
    return words[:, :max_words]


@functools.partial(jax.jit, static_argnums=(2, 3))
def pack_bits(lens: jnp.ndarray, vals: jnp.ndarray, max_words: int,
              method: str = "segsum"):
    """Pack codewords into per-segment uint32 word streams.

    Args:
      lens: (num_segments, L) int32 codeword bit lengths; 0 marks padding
        samples (they contribute nothing).
      vals: (num_segments, L) uint32 right-aligned codeword bit patterns.
      max_words: static output width (>= worst case, cfg.max_words(L)).

    Returns:
      words: (num_segments, max_words) uint32, zero beyond each stream.
      nwords: (num_segments,) int32 true word counts.
    """
    w0, hi, lo, nbits = _contributions(lens, vals)
    if method == "segsum":
        words = _pack_segsum(w0, hi, lo, max_words)
    elif method == "scatter":
        words = _pack_scatter(w0, hi, lo, max_words)
    else:
        raise ValueError(f"unknown pack method {method!r}")
    nwords = (nbits + 31) >> 5
    valid = jnp.arange(max_words, dtype=jnp.int32)[None, :] < nwords[:, None]
    return jnp.where(valid, words, 0), nwords


@functools.partial(jax.jit, static_argnums=(1, 2))
def unpack_bits(words: jnp.ndarray, n_samples: int, k: int) -> jnp.ndarray:
    """Decode Rice codewords from per-segment word streams.

    Args:
      words: (num_segments, W) uint32; each row one stream, zero-padded, with
        W at least (stream words + 1).
      n_samples: samples to decode per segment (padding rows produce garbage
        that callers mask).
      k: log2(M).

    Returns:
      (num_segments, n_samples) uint32 zigzag values.
    """
    nw, w = words.shape
    maxbit = jnp.int32(32 * (w - 1))
    kmask = _U32((1 << k) - 1)

    def step(bit, _):
        wi = bit >> 5
        pair = jnp.take_along_axis(
            words, jnp.stack([wi, wi + 1], axis=-1), axis=-1, mode="clip"
        )
        w0, w1 = pair[:, 0], pair[:, 1]
        off = (bit & 31).astype(_U32)
        win = (w0 << off) | jnp.where(
            off == 0, _U32(0), w1 >> ((_U32(32) - off) & _U32(31))
        )
        # leading-zero count gives the unary quotient; 8 zeros flag an escape
        q = jnp.minimum(jax.lax.clz(win), _U32(ESCAPE_Q))
        esc = q == ESCAPE_Q
        rsh = jnp.clip(32 - q.astype(jnp.int32) - 1 - k, 0, 31).astype(_U32)
        u_plain = (q << k) | ((win >> rsh) & kmask)
        u_esc = (win >> _U32(32 - ESCAPE_LEN)) & _U32(0xFFFF)
        u = jnp.where(esc, u_esc, u_plain)
        clen = jnp.where(esc, ESCAPE_LEN, q.astype(jnp.int32) + 1 + k)
        return jnp.minimum(bit + clen, maxbit), u

    bit0 = jnp.zeros((nw,), dtype=jnp.int32)
    _, us = jax.lax.scan(step, bit0, None, length=n_samples)
    return jnp.swapaxes(us, 0, 1)
