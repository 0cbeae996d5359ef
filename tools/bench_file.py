"""End-to-end HDF5 file<->RAM benchmark — the reference's headline metric
(``/root/reference/docs/Performance.md:3-25``: h5py, repeated writes and
reads of one dataset). Two comparators run on the same data and host:

* ``direct_chunk`` — this framework's public HDF5 path
  (``h5.write_dataset`` / ``h5.read_dataset``): device codec plus
  direct-chunk I/O.
* ``native_plugin`` — this framework's C filter plugin (OpenMP) through
  the standard h5py filter pipeline.

Files go to ``build/bench_file/`` inside the checkout (or ``--workdir``).
Prints one JSON line per geometry. Needs a GPU for the direct-chunk path.

Usage: python tools/bench_file.py [--geom nab|nedm|noptrex|all] [--mb 64]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the reference's three published file benchmarks, with its exact chunk
# shapes and segment lengths (/root/reference/docs/Performance.md:14,27,38);
# M=8 + delta filter for all three, as the reference used. sigma shapes the
# random-walk data so compressed ratios land near the published 29/27/25%.
GEOMETRIES = {
    "nab": {"length": 7000, "chunk_rows": 2000, "sigma": 10.0},
    "nedm": {"length": 81920, "chunk_rows": 32, "sigma": 8.0},
    "noptrex": {"length": 500000, "chunk_rows": 32, "sigma": 6.0},
}


def _make_data(geom: str, mb: float) -> np.ndarray:
    g = GEOMETRIES[geom]
    length, chunk_rows = g["length"], g["chunk_rows"]
    rows_per_chunk_bytes = chunk_rows * length * 2
    nchunks = max(1, int(mb * 1e6) // rows_per_chunk_bytes)
    rows = nchunks * chunk_rows
    rng = np.random.default_rng(0)
    x = np.cumsum(
        np.round(rng.normal(0, g["sigma"], (rows, length))), axis=-1
    ).astype(np.int16)
    return x


def _time(write, read, x, iters):
    """Host-clock seconds of each write and read; returns (write_MBps,
    read_MBps) from the medians and checks the last read."""
    tw, tr = [], []
    got = None
    for _ in range(iters):
        t0 = time.perf_counter()
        write()
        tw.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = read()
        tr.append(time.perf_counter() - t0)
    if not np.array_equal(got, x):
        raise AssertionError("file round trip failed")
    mb = x.nbytes / 1e6
    return mb / float(np.median(tw)), mb / float(np.median(tr))


def _direct_chunk(path, x, cfg, chunk_rows, iters):
    import h5py

    from deltarice_tpu import h5 as drh5

    def write():
        with h5py.File(path, "w") as f:
            drh5.write_dataset(f, "d", x, cfg, chunks=(chunk_rows, x.shape[1]))

    def read():
        with h5py.File(path, "r") as f:
            return drh5.read_dataset(f["d"])

    return _time(write, read, x, iters)


def _native_plugin(path, x, cfg, chunk_rows, iters):
    import h5py

    from deltarice_tpu.native import register_with_h5py

    if not register_with_h5py():
        raise RuntimeError("native plugin registration failed")

    def write():
        with h5py.File(path, "w") as f:
            f.create_dataset("d", data=x, chunks=(chunk_rows, x.shape[1]),
                             compression=32025,
                             compression_opts=cfg.to_cd_values())

    def read():
        with h5py.File(path, "r") as f:
            return f["d"][()]

    return _time(write, read, x, iters)


def run(geom: str, mb: float, iters: int, base: Path) -> dict:
    import jax

    from deltarice_tpu.config import RiceConfig

    g = GEOMETRIES[geom]
    x = _make_data(geom, mb)
    cfg = RiceConfig(8, g["length"])
    row = {"geometry": geom, "file_MB": x.nbytes / 1e6,
           "chunk": [g["chunk_rows"], g["length"]]}
    w, r = _direct_chunk(base / f"direct_{geom}.h5", x, cfg,
                         g["chunk_rows"], iters)
    row["direct_chunk"] = {"write_MBps": w, "read_MBps": r}
    w, r = _native_plugin(base / f"native_{geom}.h5", x, cfg,
                          g["chunk_rows"], iters)
    row["native_plugin"] = {"write_MBps": w, "read_MBps": r}
    dev = jax.devices()[0]
    row["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    return row


def main():
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--geom", default="all")
    ap.add_argument("--mb", type=float, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--workdir", default=str(REPO / "build" / "bench_file"))
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench_file needs a GPU for the direct-chunk path")
    base = Path(args.workdir)
    os.makedirs(base, exist_ok=True)
    geoms = list(GEOMETRIES) if args.geom == "all" else [args.geom]
    for geom in geoms:
        print(json.dumps(run(geom, args.mb, args.iters, base)), flush=True)


if __name__ == "__main__":
    main()
