"""Benchmark smoke: Delta-Rice encode+decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, ...}

Baseline: the reference C filter's best published single-CPU numbers
(Threadripper 5955WX, 32 threads, Nab dataset: write 2.387 GB/s, read
1.782 GB/s — docs/Performance.md:24-25 of the reference). We report the
harmonic mean of encode and decode throughput of one Nab window (8 chunks
of 2000 x 7000 int16, M=8) through the public batch path
(``compress_batch`` / ``decompress_batch``) vs the harmonic mean of the
reference pair (2.041 GB/s).

Each call returns host bytes / host arrays, so its host-clock time ends
after the device work. The first call of each direction compiles and is
reported separately; the value is the median of ``--reps`` later calls.
Fails without a GPU: a CPU time is not a device number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools"))

BASELINE_GBPS = 2.0 / (1.0 / 2.387 + 1.0 / 1.782)  # harmonic mean ref w/r


def power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    from bench_geometries import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU, found {dev.platform!r}")
    t0 = time.perf_counter()
    row = run("nab", [("auto", "auto")], args.reps)[0]
    hm = 2.0 / (1.0 / row["encode_GBps"] + 1.0 / row["decode_GBps"])
    print(json.dumps({
        "metric": "Nab window encode+decode throughput (harmonic mean, "
                  "compress_batch/decompress_batch)",
        "value": hm,
        "unit": "GB/s",
        "vs_baseline": hm / BASELINE_GBPS,
        "encode_GBps": row["encode_GBps"],
        "decode_GBps": row["decode_GBps"],
        "first_encode_s": row["first_encode_s"],
        "first_decode_s": row["first_decode_s"],
        "ratio": row["ratio"],
        "wall_s": time.perf_counter() - t0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": power_limit(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
