"""GPU decode kernel: Rice bit-window decode with the delta prefix sum fused.

Pallas through Triton. Rice decode is serial within a stream — each
codeword's position depends on every earlier length — so one GPU thread
owns one segment and walks it in a loop inside the kernel (the XLA path,
:func:`.pack_xla.unpack_bits`, instead pays one device-loop iteration per
sample for the whole batch):

* the thread holds a 64-bit MSB-aligned bit window as two uint32 halves
  and refills it from its own row of words whenever 32 or fewer bits
  remain, so every codeword (<= 25 bits) is whole inside the top half;
* the unary quotient is ``clz`` of the top half, capped at the escape
  marker (``config.ESCAPE_Q``; escapes carry 16 raw bits);
* with the delta filter the running sum is kept in a register, so the
  kernel writes finished samples;
* sample ``i`` of every segment goes to row ``i`` of a (samples, rows)
  staging array — the 32 threads of a warp store one contiguous line — and
  XLA transposes it back.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import ESCAPE_LEN, ESCAPE_Q
from .pack_pallas import BLOCK, launch_shape

_U32 = jnp.uint32


def _clz(x):
    # Triton lowers clz for signed ints only
    return jax.lax.clz(jax.lax.bitcast_convert_type(x, jnp.int32))


def _decode_kernel(words_ref, out_ref, *, n: int, k: int, delta: bool,
                   rows: int, width: int):
    pid = pl.program_id(0)
    row = pid * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    live = row < rows
    hi = plgpu.load(words_ref.at[row, 0], mask=live, other=0)
    lo = plgpu.load(words_ref.at[row, min(1, width - 1)],
                    mask=live & (width > 1), other=0)
    kmask = _U32((1 << k) - 1)

    def step(i, carry):
        hi, lo, nb, wi, acc = carry
        # refill: bits past nb are zero, so the next word ORs in at nb
        # (nb in [14, 32] whenever a refill is due)
        need = nb <= 32
        w = plgpu.load(words_ref.at[row, jnp.minimum(wi, width - 1)],
                       mask=live & need & (wi < width), other=0)
        full = nb >= 32
        sh = jnp.minimum(nb, 31).astype(_U32)
        hi = jnp.where(need & ~full, hi | (w >> sh), hi)
        lo = jnp.where(need, jnp.where(full, w, w << (_U32(32) - sh)), lo)
        wi = jnp.where(need, wi + 1, wi)
        nb = jnp.where(need, nb + 32, nb)
        # decode one codeword from the top half
        q = jnp.minimum(_clz(hi), ESCAPE_Q)
        esc = q == ESCAPE_Q
        u_plain = ((q.astype(_U32) << k)
                   | ((hi >> (31 - q - k).astype(_U32)) & kmask))
        u_esc = (hi >> _U32(32 - ESCAPE_LEN)) & _U32(0xFFFF)
        u = jnp.where(esc, u_esc, u_plain).astype(jnp.int32)
        clen = jnp.where(esc, ESCAPE_LEN, q + 1 + k)  # in [1, 25]
        cl = clen.astype(_U32)
        hi = (hi << cl) | (lo >> (_U32(32) - cl))
        lo = lo << cl
        nb = nb - clen
        d = jnp.where((u & 1) == 0, u >> 1, -((u + 1) >> 1))  # unzigzag
        acc = acc + d if delta else d  # int16 wrap happens at the store
        plgpu.store(out_ref.at[i, pl.ds(pid * BLOCK, BLOCK)],
                    acc.astype(jnp.int16))
        return hi, lo, nb, wi, acc

    zero = jnp.zeros((BLOCK,), jnp.int32)
    jax.lax.fori_loop(0, n, step, (hi, lo, zero + 64, zero + 2, zero))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def unpack_decode_pallas(words: jnp.ndarray, n_samples: int, k: int,
                         delta: bool = True, interpret: bool = False):
    """Decode per-segment word streams on the GPU.

    Args:
      words: (rows, W) uint32, one stream per row, zero-padded past it.
      n_samples: samples to decode per row (rows shorter than that decode
        garbage past their end; callers slice by true counts).
      k: log2(M).
      delta: fuse the delta filter's inverse (prefix sum); False returns
        the un-zigzagged filtered values for a generic-FIR inverse.
      interpret: run in Pallas interpret mode (CPU tests).

    Returns:
      (rows, n_samples) int16.
    """
    rows, width = words.shape
    if rows == 0 or n_samples == 0 or width == 0:
        return jnp.zeros((rows, n_samples), jnp.int16)
    programs, threads = launch_shape(rows)
    kernel = functools.partial(_decode_kernel, n=n_samples, k=k,
                               delta=delta, rows=rows, width=width)
    staged = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_samples, threads), jnp.int16),
        grid=(programs,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="deltarice_decode",
    )(words.astype(_U32))
    return staged.T[:rows]
