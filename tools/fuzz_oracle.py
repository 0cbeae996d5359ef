"""Randomized differential fuzzing against the reference C codec.

Draws random (data distribution, M, segment length, filter) configurations,
compresses with both implementations, asserts byte equality, and
cross-decodes each's output with the other. Shapes are drawn from a small
set so device compiles amortize.

Usage: python tools/fuzz_oracle.py [num_cases] [seed]
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

import deltarice_tpu as drt
from deltarice_tpu.testing.oracle import ReferenceOracle


LENGTHS = [64, 200, 1024]
FILTERS = [(1, -1), (1,), (1, -2, 1), (-1, 1), (1, -1, 0, 1)]


def random_case(rng):
    # the two long sizes drive the wide-concentration decode/encode paths
    # (slot axes >= 2**15) that short segments never reach
    n = int(rng.choice([63, 64, 200, 377, 1024, 2048, 4096, 40000, 100000]))
    dist = rng.integers(0, 4)
    if dist == 0:
        data = np.round(
            np.cumsum(rng.normal(0, rng.uniform(1, 50), n))
        )
    elif dist == 1:
        data = rng.integers(-32768, 32768, n)
    elif dist == 2:
        data = np.full(n, int(rng.integers(-32768, 32768)))
    else:
        data = rng.integers(-3, 4, n) * (
            rng.random(n) < 0.1
        ) + np.round(rng.normal(0, 2, n))
    data = np.clip(data, -32768, 32767).astype(np.int16)
    m = 1 << int(rng.integers(0, 16))
    length = int(rng.choice(LENGTHS + [-1]))
    filt = FILTERS[int(rng.integers(0, len(FILTERS)))]
    return data, drt.RiceConfig(m, length, filt)


def main(cases: int = 60, seed: int = 0) -> int:
    rng = np.random.default_rng(seed)
    oracle = ReferenceOracle()
    failures = 0
    for i in range(cases):
        data, cfg = random_case(rng)
        if not oracle.compress_is_safe(
            data.size, cfg.waveform_length
        ):
            continue  # would hit the reference's scratch-overflow UB
        cd = cfg.to_cd_values()
        ours = drt.compress(data, cfg)
        ref = oracle.compress(data, cd)
        # the reference encoder is broken for M=1 with |values| >= 16384
        # (short-typed quotient wrap + negative-shift UB; its own decoder
        # can't read those streams) — there we only require that the
        # reference can read OUR correct stream. See docs/Interop.md.
        # (the wrap happens on the FILTERED values' zigzag, so just gate
        # on M: M=1 byte-equality only holds when no filtered magnitude
        # reaches 16384, which we don't bother predicting)
        ref_trustworthy = cfg.m >= 2
        ok_bytes = ours == ref or not ref_trustworthy
        ok_cross1 = np.array_equal(oracle.decompress(ours, cd), data)
        back = drt.decompress(ref, cfg)
        ok_cross2 = (
            np.array_equal(back, data)
            or not cfg.lossless
            or not ref_trustworthy
        )
        if not (ok_bytes and ok_cross1 and ok_cross2):
            failures += 1
            print(
                f"FAIL case {i}: n={data.size} cfg={cfg} "
                f"bytes={ok_bytes} ref-reads-ours={ok_cross1} "
                f"we-read-refs={ok_cross2}"
            )
        if (i + 1) % 10 == 0:
            print(f"{i + 1}/{cases} cases, {failures} failures", flush=True)
    print(f"done: {cases} cases, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    s = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    sys.exit(main(n, s))
