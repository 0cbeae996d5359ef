"""End-to-end codec throughput at the reference's published geometries,
through the public batch path (``compress_batch`` / ``decompress_batch``).

Geometries (``/root/reference/docs/Performance.md:14,27,38``): Nab chunks
of 2000 x 7000 samples at M=8, nEDM@SNS 32 x 81920 at M=16, NOPTREX
32 x 500000 at M=8 — plus an escape-heavy Nab-shaped batch (uniform int16,
M=2). Each run encodes and decodes one window of chunks, checks the round
trip, and times both directions on the host clock (the calls return host
bytes / arrays, so they end after the device work).

Usage:
  python tools/bench_geometries.py [--only nab,nedm] [--reps 3]
         [--paths pallas:pallas,segsum:scan]

``--paths`` lists encode-method:decode-backend pairs, so one process can
time the GPU kernels and the plain XLA path side by side; the pairs take
turns rep by rep, and every pair must produce the same bytes. Prints one
JSON line per (geometry, path) with every rep's seconds and the median's
GB/s. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deltarice_tpu.codec import compress_batch, decompress_batch  # noqa: E402
from deltarice_tpu.config import RiceConfig  # noqa: E402

#: chunk rows x segment length, Rice M, data kind and scale, chunks per window
GEOMETRIES = {
    "nab": dict(rows=2000, length=7000, m=8, kind="walk", sigma=10.0,
                window=8),
    # sigma 4 matches models/profiles.py's nEDM profile: at M=16 the ratio
    # sits just above the 5/16 floor every int16 input has at M=16
    "nedm": dict(rows=32, length=81920, m=16, kind="walk", sigma=4.0,
                 window=64),
    "noptrex": dict(rows=32, length=500000, m=8, kind="walk", sigma=8.0,
                    window=8),
    "escape": dict(rows=2000, length=7000, m=2, kind="uniform", sigma=0.0,
                   window=2),
}


def make_data(kind: str, shape, sigma: float, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":  # incompressible: every sample escapes
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    return np.cumsum(
        np.round(rng.normal(0, sigma, shape)), axis=-1
    ).astype(np.int16)


def window(name: str, seed: int = 0, chunks: int | None = None):
    """(list of (rows, length) int16 chunks, RiceConfig) for a geometry."""
    g = GEOMETRIES[name]
    n = chunks or g["window"]
    x = make_data(g["kind"], (n, g["rows"], g["length"]), g["sigma"], seed)
    return list(x), RiceConfig(g["m"], g["length"])


def run(name: str, paths, reps: int, chunks: int | None = None) -> list:
    """Time ``reps`` encodes and decodes of one window per
    (encode-method, decode-backend) pair, the pairs interleaved rep by rep
    so slow drift of the host affects every path alike."""
    data, cfg = window(name, chunks=chunks)
    nbytes = sum(c.nbytes for c in data)
    rows = []
    for method, backend in paths:
        t0 = time.perf_counter()
        blobs = compress_batch(data, cfg, method)
        first_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = decompress_batch(blobs, cfg, backend)
        first_dec = time.perf_counter() - t0
        for c, o in zip(data, outs):
            if not np.array_equal(o, c.ravel()):
                raise AssertionError(f"{name}: round trip failed")
        if rows and blobs != rows[0]["blobs"]:
            raise AssertionError(f"{name}: {method} bytes differ from "
                                 f"{rows[0]['encode']}")
        rows.append({"encode": method, "decode": backend, "blobs": blobs,
                     "first_encode_s": first_enc,
                     "first_decode_s": first_dec,
                     "encode_s": [], "decode_s": []})
    for _ in range(reps):
        for row in rows:
            t0 = time.perf_counter()
            again = compress_batch(data, cfg, row["encode"])
            row["encode_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            decompress_batch(row["blobs"], cfg, row["decode"])
            row["decode_s"].append(time.perf_counter() - t0)
            if again != row["blobs"]:
                raise AssertionError(f"{name}: encode not deterministic")
    g = GEOMETRIES[name]
    for row in rows:
        stored = sum(len(b) for b in row.pop("blobs"))
        row.update({"geometry": name, "chunks": len(data),
                    "chunk": [g["rows"], g["length"]], "m": cfg.m,
                    "MB": nbytes / 1e6, "ratio": stored / nbytes})
        for d in ("encode", "decode"):
            ts = row[f"{d}_s"]
            row[f"{d}_GBps"] = (nbytes / float(np.median(ts)) / 1e9
                                if ts else None)
    return rows


def main():
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(GEOMETRIES))
    ap.add_argument("--paths", default="pallas:pallas")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_geometries needs a GPU, found {dev.platform!r}")
    paths = [pair.split(":") for pair in args.paths.split(",")]
    for name in args.only.split(","):
        for row in run(name, paths, args.reps):
            row["device"] = {"platform": dev.platform,
                             "kind": dev.device_kind,
                             "count": len(jax.devices())}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
