"""Per-stage times of one window through the batch codec, and device-only
times of the GPU kernels against the plain XLA path at the codec's shapes.

Replays the stages of ``compress_batch`` and ``decompress_batch`` one at a
time on the host clock (each ends in ``block_until_ready`` or a host copy),
so the end-to-end time of a window can be split into host padding, copies,
kernels, sub-stream merge, framing, header walk and output copies.

Usage:
  python tools/stage_times.py [--only nab,nedm] [--reps 5]

Prints one JSON line per geometry (median ms of ``--reps`` runs per
stage; the XLA decode of 500,000-sample segments takes two). Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench_geometries as geo  # noqa: E402
from deltarice_tpu import codec as C  # noqa: E402


def median_ms(fn, reps):
    """Median ms of ``reps`` calls of ``fn`` after one untimed call."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def median_fetch_ms(make, reps):
    """Median ms of copying a freshly made device array to the host (a
    fetched array caches its host copy, so each rep makes a new one)."""
    ts = []
    for _ in range(reps):
        arr = jax.block_until_ready(make())
        t0 = time.perf_counter()
        np.asarray(arr)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def stages(name: str, reps: int) -> dict:
    data, cfg = geo.window(name, seed=1)
    arrs = [C.as_int16(c).ravel() for c in data]
    total, nchunks = arrs[0].size, len(arrs)
    nseg, length, nvalid = C._segment_layout(total, cfg)
    st = {}

    # --- encode: the steps of compress_batch_dispatch / _collect
    def pad():
        padded = np.zeros((nchunks, nseg, length), np.int16)
        padded.reshape(nchunks, -1)[:, :total] = np.stack(arrs)
        return padded.reshape(nchunks * nseg, length)

    st["host_pad_ms"] = median_ms(pad, reps)
    rows2, nv2 = pad(), np.tile(nvalid, nchunks)
    parts = C._split_parts(nseg, length, cfg)
    if parts > 1:
        st["host_split_layout_ms"] = median_ms(
            lambda: C._split_layout(rows2, nv2, parts), reps)
        xs, nvs, p0, ls = C._split_layout(rows2, nv2, parts)
    else:
        xs, nvs, p0, ls = rows2, nv2, np.zeros(len(nv2), np.int32), length
    mw = cfg.max_words(ls)
    st["h2d_samples_ms"] = median_ms(lambda: jax.device_put(xs), reps)
    xd, nvd, p0d = jax.device_put(xs), jnp.asarray(nvs), jnp.asarray(p0)

    def encode(method):
        return C.encode_segments_bits(xd, nvd, cfg, mw, method, p0d)

    st["dev_encode_kernel_ms"] = median_ms(lambda: encode("pallas"), reps)
    st["dev_encode_xla_ms"] = median_ms(lambda: encode("segsum"), reps)
    words, nwords, nbits = encode("pallas")

    def fetch():
        nw = np.asarray(nwords)
        return np.asarray(words[:, :max(int(nw.max(initial=0)), 1)]), nw

    st["d2h_words_ms"] = median_ms(fetch, reps)
    fetched, nw = fetch()
    if parts > 1:
        rows = nchunks * nseg
        w = fetched.shape[1]
        nb = np.asarray(nbits).reshape(rows, parts)

        def merge():
            return C.merge_substreams(fetched.reshape(rows, parts, w), nb)

        st["host_merge_ms"] = median_ms(merge, reps)
        fetched, nw = merge()
    merged = fetched.reshape(nchunks, nseg, -1)
    nw = nw.reshape(nchunks, nseg)

    def frame():
        return [C.frame_stream(total, merged[c], nw[c])
                for c in range(nchunks)]

    st["host_frame_ms"] = median_ms(frame, reps)
    blobs = frame()
    if blobs != C.compress_batch(data, cfg):
        raise AssertionError(f"{name}: staged encode differs from "
                             "compress_batch")
    st["e2e_compress_batch_ms"] = median_ms(
        lambda: C.compress_batch(data, cfg), reps)

    # --- decode: the steps of decompress_batch_dispatch / _collect
    def walk_gather():
        bufs = [np.frombuffer(b, "<u4") for b in blobs]
        per = [C.walk_headers(b, nseg) for b in bufs]
        top = max(int(c.max(initial=0)) for c, _ in per) + 1
        bucket = -(-top // C._WORD_BUCKET) * C._WORD_BUCKET
        out = np.zeros((nchunks, nseg, bucket), np.uint32)
        for j, (b, (c, s)) in enumerate(zip(bufs, per)):
            out[j] = C.gather_segments(b, c, s, bucket)
        return out.reshape(-1, bucket)

    st["host_walk_gather_ms"] = median_ms(walk_gather, reps)
    wh = walk_gather()
    st["h2d_words_ms"] = median_ms(lambda: jax.device_put(wh), reps)
    wd = jax.device_put(wh)

    def decode(backend):
        return C.decode_segments(wd, length, cfg, backend)

    st["dev_decode_kernel_ms"] = median_ms(lambda: decode("pallas"), reps)
    st["dev_decode_xla_ms"] = median_ms(lambda: decode("scan"),
                                        2 if length > 100_000 else reps)
    st["d2h_samples_ms"] = median_fetch_ms(lambda: decode("pallas"), reps)
    dn = np.asarray(decode("pallas")).reshape(nchunks, -1)
    st["host_copy_out_ms"] = median_ms(
        lambda: [dn[j, :total].copy() for j in range(nchunks)], reps)
    st["e2e_decompress_batch_ms"] = median_ms(
        lambda: C.decompress_batch(blobs, cfg), reps)
    return {"geometry": name, "rows": int(xs.shape[0]),
            "length": int(xs.shape[1]),
            "MB": sum(c.nbytes for c in data) / 1e6, "reps": reps, **st}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(geo.GEOMETRIES))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"stage_times needs a GPU, found {dev.platform!r}")
    for name in args.only.split(","):
        row = stages(name, args.reps)
        row["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
