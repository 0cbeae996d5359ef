"""Butterfly concentration (:mod:`deltarice_tpu.ops.concentrate`, XLA)
checked against a direct numpy compaction model.

The reference has no counterpart (its streams are compacted serially by a
bit cursor, /root/reference/src/deltaRice.c:191-244).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from deltarice_tpu.ops.concentrate import concentrate


def make_case(rows, r, density, seed=0, dtype=np.int16):
    """Random monotone conflict-free (values, disp, dense reference)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((rows, r)) < density
    dest = np.cumsum(valid, axis=1) - 1
    disp = np.where(valid, np.arange(r)[None, :] - dest, -1).astype(np.int32)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max + 1, (rows, r)).astype(dtype)
    n_out = max(int(valid.sum(axis=1).max()), 1)
    dense = np.zeros((rows, n_out), dtype=dtype)
    for i in range(rows):
        got = vals[i, valid[i]]
        dense[i, : got.size] = got
    return vals, disp, n_out, dense


@pytest.mark.parametrize("density", [0.0, 0.1, 0.55, 1.0])
def test_xla_concentrate_matches_numpy(density):
    vals, disp, n_out, dense = make_case(16, 1000, density, seed=3)
    out = np.asarray(concentrate(jnp.asarray(vals), jnp.asarray(disp), n_out))
    assert np.array_equal(out, dense)


@pytest.mark.parametrize("r", [500, 40000])
def test_n_out_wider_than_slot_axis(r):
    """A stream shorter than its segment stages fewer slots than the
    requested samples (fuzz-found: 64 samples decoded as a 1024-sample
    segment); the surplus output columns must zero-pad, not crash or
    silently narrow."""
    vals, disp, n_out, dense = make_case(16, r, 0.2, seed=9)
    want = r + 300
    out = np.asarray(concentrate(jnp.asarray(vals), jnp.asarray(disp), want))
    assert out.shape == (16, want)
    assert np.array_equal(out[:, :n_out], dense)
    assert not out[:, n_out:].any()
