"""Rice-parameter and pre-filter optimization.

The reference documents (but does not ship) an "optimal filter
determination routine" (``/root/reference/docs/Optimization.md:5-21``):
minimize the expected encoded bits per sample
``B(m, c) = sum_i P(x_i) * b(x_i, m, c)`` estimated from sample data, by
(a) sweeping the Rice parameter M over powers of two and (b) greedy
hill-climbing over integer filter coefficients, examining all neighbors
within +/-span per tap ((2*span+1)^n_taps candidates), memoizing evaluated
filters, rejecting trailing-zero taps, and stopping when no neighbor
improves. This module implements that spec as batched device work: the
bit-cost of every (candidate filter, candidate M) pair is a vectorized
JAX evaluation over the sample waveforms — candidate filters batch on one
axis, all 16 values of k evaluate simultaneously on another.
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from .config import ESCAPE_LEN, ESCAPE_Q, RiceConfig
from .ops.prefilter import _c16, _shift_right, prefilter_encode
from .ops.rice import zigzag

_KS = 16  # candidate k values: 0..15 (M = 1..32768)


def codeword_bits(u: jnp.ndarray, k: int | jnp.ndarray) -> jnp.ndarray:
    """Exact per-sample codeword length in bits for zigzag values u."""
    q = (u.astype(jnp.int32) >> k)
    return jnp.where(q >= ESCAPE_Q, ESCAPE_LEN, q + 1 + k)


@jax.jit
def _bits_all_k(d: jnp.ndarray) -> jnp.ndarray:
    """Mean bits/sample of filtered data d for every k in [0, 16)."""
    u = zigzag(d).ravel()
    ks = jnp.arange(_KS, dtype=jnp.int32)
    def mean_bits(k):
        return jnp.mean(codeword_bits(u, k).astype(jnp.float32))
    return jax.vmap(mean_bits)(ks)


def expected_bits(data, m: int, filt=(1, -1)) -> float:
    """Expected encoded bits/sample for the given config on sample data."""
    x = jnp.asarray(np.asarray(data, dtype=np.int16))
    d = prefilter_encode(x, tuple(int(c) for c in filt))
    cfg = RiceConfig(m)
    return float(_bits_all_k(d)[cfg.k])


def optimal_m(data, filt=(1, -1)) -> int:
    """Best power-of-two Rice parameter for the data under ``filt``."""
    x = jnp.asarray(np.asarray(data, dtype=np.int16))
    d = prefilter_encode(x, tuple(int(c) for c in filt))
    k = int(jnp.argmin(_bits_all_k(d)))
    return 1 << k


@functools.partial(jax.jit, static_argnums=(2,))
def _batch_filter_bits(x: jnp.ndarray, filts: jnp.ndarray,
                       n_taps: int) -> jnp.ndarray:
    """Mean bits/sample for EVERY (candidate filter, k) pair in one
    dispatch: candidate filters batch on a ``vmap`` axis, all 16 k values
    on another — the reference's documented routine
    (``/root/reference/docs/Optimization.md:14-21``) fully vectorized.

    x: (S, L) int16 sample waveforms.
    filts: (C, n_taps) int32, coefficients already wrapped mod 2**16.
    Returns (C, 16) float32.
    """
    xs = [
        _shift_right(x, j).astype(jnp.int32) for j in range(n_taps)
    ]

    def one(f):
        acc = xs[0] * f[0]
        for j in range(1, n_taps):
            acc = acc + xs[j] * f[j]
        # per-tap int16 accumulation in the reference wraps mod 2**16 —
        # a ring homomorphism, so wrapping the int32 sum once is identical
        d = ((acc << 16) >> 16).astype(jnp.int16)
        return _bits_all_k(d)

    return jax.vmap(one)(filts)


def _filter_costs(x: jnp.ndarray, cands: list[tuple[int, ...]],
                  pad_to: int) -> list[tuple[int, float]]:
    """(best k, bits at best k) for each candidate, one jit call.

    The candidate batch pads to a fixed size so every hill-climb round
    reuses one compiled program.
    """
    n_taps = len(cands[0])
    rows = cands + [cands[0]] * (pad_to - len(cands))
    filts = jnp.asarray(
        [[int(_c16(c)) for c in f] for f in rows], dtype=jnp.int32
    )
    bits = np.asarray(_batch_filter_bits(x, filts, n_taps))[: len(cands)]
    ks = bits.argmin(axis=1)
    return [(int(k), float(b[k])) for k, b in zip(ks, bits)]


def _neighbors(filt: tuple[int, ...], span: int):
    """All filters within +/-span per tap, excluding trailing zeros and
    a zero leading coefficient (the inverse divides by filt[0])."""
    deltas = range(-span, span + 1)
    for offs in itertools.product(deltas, repeat=len(filt)):
        cand = tuple(c + o for c, o in zip(filt, offs))
        if cand == filt or cand[0] == 0 or (len(cand) > 1 and cand[-1] == 0):
            continue
        yield cand


def optimize(data, n_taps: int = 2, span: int = 1, start=None,
             max_rounds: int = 64) -> RiceConfig:
    """Greedy hill-climb over integer filter taps + exact M sweep.

    Returns the best :class:`RiceConfig` found (waveform_length is left at
    the default; set it from your chunking). Matches the reference's
    documented routine; lossless configs only are returned (|filt[0]|==1).
    """
    x = jnp.asarray(np.asarray(data, dtype=np.int16))
    if x.ndim == 1:
        x = x[None, :]
    cur = tuple(start) if start else ((1, -1) + (0,) * (n_taps - 2))[:n_taps]
    if len(cur) != n_taps:
        cur = (cur + (0,) * n_taps)[:n_taps]
    if cur[-1] == 0 and n_taps > 1:
        cur = cur[:-1] + (-1,)
    memo: dict[tuple[int, ...], tuple[int, float]] = {}
    pad_to = (2 * span + 1) ** n_taps  # one compiled shape for every round

    def costs(fs: list[tuple[int, ...]]) -> None:
        fresh = [f for f in fs if f not in memo]
        if fresh:
            for f, kb in zip(fresh, _filter_costs(x, fresh, pad_to)):
                memo[f] = kb

    costs([cur])
    best_k, best_bits = memo[cur]
    for _ in range(max_rounds):
        # lossless reconstruction requires |filt[0]| == 1
        cands = [c for c in _neighbors(cur, span) if abs(c[0]) == 1]
        costs(cands)  # whole neighborhood in ONE device call
        improved = False
        for cand in cands:
            k, bits = memo[cand]
            if bits < best_bits:
                cur, best_k, best_bits, improved = cand, k, bits, True
        if not improved:
            break
    return RiceConfig(m=1 << best_k, filt=cur)
