"""GPU encode kernel: fused delta / zigzag / Rice codeword / bit pack.

Pallas through Triton. One GPU thread owns one segment and writes its
bitstream in order — the scheme of the native codec's ``bw_put``
(``native/src/dr_codec.c``) and of the reference's serial 32-bit
accumulator (``compressWithRiceCoding``):

* the thread walks its segment's samples in a loop inside the kernel,
  carrying the previous sample (delta state), a 32-bit accumulator and its
  fill count;
* each sample's codeword (<= 25 bits) is appended; when the accumulator
  fills, the completed uint32 word is stored at the segment's next word
  index and the overflow bits start the next word;
* after the last valid sample the partial word is flushed, zero-filled at
  the low end like the reference (``deltaRice.c:237-241``).

Samples are read from a (L, rows) transposed copy, so the 32 threads of a
warp load one contiguous 64-byte line per step. Words go straight to their
final (rows, max_words) position; the output buffer starts as zeros so
everything past each stream is zero (the sub-stream merge relies on it).

The XLA packer (:mod:`.pack_xla`) computes the same words with prefix sums
and is the reference these kernels are tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import ESCAPE_LEN, ESCAPE_Q

_U32 = jnp.uint32

#: segments (GPU threads) per program; one warp per program
BLOCK = 32


def launch_shape(rows: int) -> tuple[int, int]:
    """(programs, threads) one kernel call launches for ``rows`` segments
    — one thread per segment, rounded up to whole programs."""
    programs = -(-rows // BLOCK)
    return programs, programs * BLOCK


def _encode_kernel(xt_ref, nv_ref, p0_ref, _zeros_ref, words_ref, nw_ref,
                   nb_ref, *, length: int, k: int, diff: bool, rows: int,
                   max_words: int):
    pid = pl.program_id(0)
    row = pid * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    live = row < rows
    nv = plgpu.load(nv_ref.at[row], mask=live, other=0)
    prev0 = plgpu.load(p0_ref.at[row], mask=live, other=0)
    kmask = _U32((1 << k) - 1)
    last = max_words - 1

    def step(i, carry):
        prev, acc, nb, nw = carry
        x = plgpu.load(xt_ref.at[i, pl.ds(pid * BLOCK, BLOCK)])
        x = x.astype(jnp.int32)
        if diff:
            d = ((x - prev) << 16) >> 16  # wrapping int16 difference
            prev = x
        else:
            d = x
        u = ((d << 1) ^ (d >> 31)).astype(_U32)  # zigzag
        q = u >> k
        esc = q >= ESCAPE_Q
        ln = jnp.where(esc, ESCAPE_LEN, q.astype(jnp.int32) + 1 + k)
        val = jnp.where(esc, _U32(1 << 16) | u, _U32(1 << k) | (u & kmask))
        ln = jnp.where(i < nv, ln, 0)
        # append ln bits to the acc's nb: every shift stays in [0, 31]
        # (Triton shifts by >= 32 are undefined)
        tot = nb + ln
        fits = tot < 32
        part = jnp.where(fits & (ln > 0),
                         val << jnp.clip(32 - tot, 0, 31).astype(_U32),
                         _U32(0))
        word = acc | (val >> jnp.clip(tot - 32, 0, 31).astype(_U32))
        rest = jnp.where(tot > 32,
                         val << jnp.clip(64 - tot, 0, 31).astype(_U32),
                         _U32(0))
        plgpu.store(words_ref.at[row, jnp.minimum(nw, last)], word,
                    mask=live & ~fits)
        acc = jnp.where(fits, acc | part, rest)
        nb = jnp.where(fits, tot, tot - 32)
        nw = nw + (~fits).astype(jnp.int32)
        return prev, acc, nb, nw

    zero = jnp.zeros((BLOCK,), jnp.int32)
    _, acc, nb, nw = jax.lax.fori_loop(
        0, length, step, (prev0, jnp.zeros((BLOCK,), _U32), zero, zero)
    )
    tail = nb > 0
    plgpu.store(words_ref.at[row, jnp.minimum(nw, last)], acc,
                mask=live & tail)
    plgpu.store(nb_ref.at[row], nw * 32 + nb, mask=live)
    plgpu.store(nw_ref.at[row], nw + tail.astype(jnp.int32), mask=live)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 6))
def pack_encode_pallas(x: jnp.ndarray, nvalid: jnp.ndarray, k: int,
                       max_words: int, diff: bool = True, prev0=None,
                       interpret: bool = False):
    """Encode (rows, L) int16 segments to Rice word streams on the GPU.

    Args:
      x: (rows, L) int16 samples (or pre-filtered values with
        ``diff=False``), zero past each row's ``nvalid``.
      nvalid: (rows,) valid samples per row.
      k: log2(M).
      max_words: static output width; must be >= the worst case
        (``RiceConfig.max_words(L)``).
      diff: apply the delta pre-filter in the kernel; False encodes ``x``
        as already-filtered values (generic FIR filters, split halos).
      prev0: optional (rows,) sample preceding each row's first — sub-block
        splits of a long waveform pass the previous block's last sample,
        which makes the split encode bit-identical to the serial one.
      interpret: run in Pallas interpret mode (CPU tests).

    Returns:
      (words (rows, max_words) uint32 zero past each stream,
       nwords (rows,) int32, nbits (rows,) int32)
    """
    rows, length = x.shape
    if rows == 0:
        return (jnp.zeros((0, max_words), _U32), jnp.zeros((0,), jnp.int32),
                jnp.zeros((0,), jnp.int32))
    programs, threads = launch_shape(rows)
    xt = jnp.pad(x.astype(jnp.int16), ((0, threads - rows), (0, 0))).T
    if prev0 is None:
        prev0 = jnp.zeros((rows,), jnp.int32)
    kernel = functools.partial(
        _encode_kernel, length=length, k=k, diff=diff, rows=rows,
        max_words=max_words,
    )
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((rows, max_words), _U32),
                   jax.ShapeDtypeStruct((rows,), jnp.int32),
                   jax.ShapeDtypeStruct((rows,), jnp.int32)),
        grid=(programs,),
        input_output_aliases={3: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="deltarice_encode",
    )(xt, nvalid.astype(jnp.int32), prev0.astype(jnp.int32),
      jnp.zeros((rows, max_words), _U32))
