"""Seeded randomized round-trips through the PRODUCTION code paths.

Every draw goes through ``compress``/``decompress`` exactly like a user
call, so whichever adaptive machinery the draw triggers — sub-block-split
encode, service-rate decode with lookback, speculative wide16 compaction,
flagged exact re-decodes — must compose to bit-exact results. Seeds are
fixed: failures reproduce.
"""

from __future__ import annotations

import numpy as np
import pytest


import deltarice_tpu as drt


def _draw(rng):
    m = int(2 ** rng.integers(0, 8))
    kind = rng.choice(["walk", "uniform", "mixed", "const"])
    length = int(rng.integers(33, 6000))
    nseg = int(rng.integers(1, 12))
    # occasionally a custom pre-filter (identity, double-delta, or a
    # random +-1-leading FIR) instead of the default delta
    filt = (1, -1)
    pick = rng.integers(0, 5)
    if pick == 1:
        filt = (1,)
    elif pick == 2:
        filt = (1, -2, 1)
    elif pick == 3:
        filt = (int(rng.choice([1, -1])),) + tuple(
            int(v) for v in rng.integers(-3, 4, int(rng.integers(1, 4)))
        )
    total = int(rng.integers(1, nseg * length + 1))
    if kind == "walk":
        x = np.round(
            np.cumsum(rng.normal(0, rng.uniform(0.3, 40), total))
        ).astype(np.int16)
    elif kind == "uniform":
        x = rng.integers(-32768, 32768, total).astype(np.int16)
    elif kind == "mixed":
        x = np.round(
            np.cumsum(rng.normal(0, 5, total))
        ).astype(np.int16)
        burst = rng.integers(0, max(total - 1, 1))
        x[burst:] = rng.integers(-32768, 32768, total - burst)
    else:
        x = np.full(total, rng.integers(-32768, 32768), np.int16)
    return x, drt.RiceConfig(m, length, filt)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_roundtrip_cpu_paths(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(4):
        x, cfg = _draw(rng)
        blob = drt.compress(x, cfg)
        np.testing.assert_array_equal(drt.decompress(blob, cfg), x)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(2, 6))
def test_fuzz_roundtrip_cpu_paths_deep(seed):
    """Seeds 2-5: same draws, kept out of the fast tier (every fresh
    (shape, k, filter) draw pays a first XLA compile)."""
    test_fuzz_roundtrip_cpu_paths(seed)


@pytest.mark.slow
@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_fuzz_roundtrip_long_segments(seed):
    """Long-segment draws through the GPU kernels: split encode + one
    decode thread per long segment."""
    rng = np.random.default_rng(2000 + seed)
    length = int(rng.integers(30000, 140000))
    nseg = int(rng.integers(1, 4))
    sigma = float(rng.uniform(0.5, 500))
    x = np.round(
        np.cumsum(rng.normal(0, sigma, nseg * length))
    ).astype(np.int16)
    cfg = drt.RiceConfig(int(2 ** rng.integers(1, 6)), length)
    blob = drt.compress(x, cfg)
    np.testing.assert_array_equal(drt.decompress(blob, cfg), x)
