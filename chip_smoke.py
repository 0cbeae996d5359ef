"""Smoke run of the Delta-Rice codec on one GPU, through the public entry
points, at the published geometries.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # the chunk mesh over 4 cards, only

Phases (one card):
  1. build the native C library from this checkout's sources
  2. require a GPU as JAX's first device
  3. card, JAX version and the route each kernel takes
  4. compress_batch -> decompress_batch on a Nab, an nEDM, a NOPTREX and an
     escape-heavy window (random data from a seed): every stream equals the
     native C codec's dr_compress bytes, every sample round-trips
  5. the committed golden vectors, encoded and decoded byte for byte
  6. each kernel against the plain XLA path on 64 rows at each real width
  7. HDF5 write/read of a Nab dataset (when h5py is installed)
  8. the tests marked ``gpu``, in this process

Any failure exits non-zero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}. Times
printed here are smoke numbers (one window, first call compiles), not
benchmark results.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20251016


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def peak_bytes(jax) -> int:
    return max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def build_native() -> None:
    from deltarice_tpu import native

    native.build()
    log(f"[1] native C library: {native.library_path().name}, "
        f"host framing native={native.codec_lib() is not None}")
    if native.codec_lib() is None:
        raise RuntimeError("native codec library did not load")


def require_gpu(jax, count: int) -> None:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's first device is "
                         f"{dev.platform!r}")
    if len(jax.devices()) < count:
        raise SystemExit(f"needs {count} GPUs, found {len(jax.devices())}")
    log(f"[2] device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")


def codec_windows(bench):
    from deltarice_tpu.backend import resolve
    from deltarice_tpu.codec import (
        _split_parts, compress_batch, decompress_batch)
    from deltarice_tpu.native import native_compress
    from deltarice_tpu.ops.pack_pallas import launch_shape

    assert resolve("auto", "segsum") == resolve("auto", "scan") == "pallas"
    for name in ("nab", "nedm", "noptrex", "escape"):
        data, cfg = bench.window(name, seed=SEED)
        g = bench.GEOMETRIES[name]
        nbytes = sum(c.nbytes for c in data)
        blobs, t_enc1 = timed(lambda: compress_batch(data, cfg))
        outs, t_dec1 = timed(lambda: decompress_batch(blobs, cfg))
        _, t_enc = timed(lambda: compress_batch(data, cfg))
        _, t_dec = timed(lambda: decompress_batch(blobs, cfg))
        for i, (c, b, o) in enumerate(zip(data, blobs, outs)):
            if b != native_compress(c, cfg.to_cd_values()):
                raise AssertionError(f"{name} chunk {i}: stream differs "
                                     f"from the native C codec")
            if not np.array_equal(o, c.ravel()):
                raise AssertionError(f"{name} chunk {i}: decode differs")
        rows = len(data) * g["rows"]
        parts = _split_parts(g["rows"], g["length"], cfg)
        log(f"[4] {name}: {len(data)} x {g['rows']}x{g['length']} M={cfg.m} "
            f"({nbytes / 1e6:.0f} MB, ratio "
            f"{sum(map(len, blobs)) / nbytes:.3f}): bytes == dr_compress, "
            f"decode exact; launch encode {launch_shape(rows * parts)} "
            f"decode {launch_shape(rows)} (programs, threads); compile "
            f"~{max(t_enc1 - t_enc, 0):.2f}s enc "
            f"~{max(t_dec1 - t_dec, 0):.2f}s dec; smoke {nbytes / t_enc / 1e9:.2f} GB/s enc, "
            f"{nbytes / t_dec / 1e9:.2f} GB/s dec (one window, host clock)")


def golden_vectors() -> None:
    import deltarice_tpu as drt
    from deltarice_tpu.codec import as_int16
    from deltarice_tpu.config import RiceConfig

    data_dir = os.path.join(ROOT, "tests", "data", "golden")
    with open(os.path.join(data_dir, "manifest.json")) as f:
        cases = json.load(f)
    for case in cases:
        cfg = RiceConfig.from_cd_values(case["cd_values"])
        x = np.load(os.path.join(data_dir, f"{case['name']}.npy"))
        with open(os.path.join(data_dir, f"{case['name']}.bin"), "rb") as f:
            golden = f.read()
        if drt.compress(x, cfg, method="pallas") != golden:
            raise AssertionError(f"golden {case['name']}: encode differs")
        out = drt.decompress(golden, cfg, backend="pallas")
        if not np.array_equal(out, as_int16(x).ravel()):
            raise AssertionError(f"golden {case['name']}: decode differs")
    log(f"[5] golden vectors: {len(cases)} cases encode and decode byte "
        f"for byte through the kernels")


def kernels_vs_xla(bench) -> None:
    import jax
    import jax.numpy as jnp

    from deltarice_tpu.codec import _decode_segments_scan, _encode_segments_xla
    from deltarice_tpu.config import RiceConfig
    from deltarice_tpu.ops.pack_pallas import pack_encode_pallas
    from deltarice_tpu.ops.unpack_pallas import unpack_decode_pallas

    for name in ("nab", "nedm", "noptrex"):
        g = bench.GEOMETRIES[name]
        cfg = RiceConfig(g["m"], g["length"])
        x = jnp.asarray(bench.make_data(g["kind"], (64, g["length"]),
                                        g["sigma"], SEED))
        nv = jnp.full((64,), g["length"], jnp.int32)
        mw = cfg.max_words(g["length"])
        (wk, nwk, nbk), tk = timed(lambda: jax.block_until_ready(
            pack_encode_pallas(x, nv, cfg.k, mw)))
        wx, nwx, nbx = _encode_segments_xla(x, nv, cfg, mw, "segsum")
        for a, b, what in ((wk, wx, "words"), (nwk, nwx, "nwords"),
                           (nbk, nbx, "nbits")):
            if not bool(jnp.array_equal(a, b)):
                raise AssertionError(f"{name}: encode {what} != XLA")
        w = int(jnp.max(nwx)) + 1
        words = wx[:, :w]
        dk, td = timed(lambda: jax.block_until_ready(
            unpack_decode_pallas(words, g["length"], cfg.k)))
        dx = _decode_segments_scan(words, g["length"], cfg)
        if not (jnp.array_equal(dk, dx) and jnp.array_equal(dk, x)):
            raise AssertionError(f"{name}: decode != XLA scan / input")
        log(f"[6] {name}: 64x{g['length']} kernel == XLA (encode words, "
            f"counts, bits; decode samples), tolerance 0; first call "
            f"{tk:.2f}s enc {td:.2f}s dec incl. compile")


def hdf5_phase(bench, rows: int = 4000) -> None:
    try:
        import h5py
    except ImportError as e:
        log(f"[7] HDF5 phase did not run: h5py is not installed ({e})")
        return
    from deltarice_tpu import h5 as drh5
    from deltarice_tpu.config import RiceConfig

    x = bench.make_data("walk", (rows, 7000), 10.0, SEED)
    cfg = RiceConfig(8, 7000)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "nab.h5")
        with h5py.File(path, "w") as f:
            _, tw = timed(lambda: drh5.write_dataset(f, "d", x, cfg,
                                                     chunks=(rows // 2, 7000)))
        with h5py.File(path, "r") as f:
            got, tr = timed(lambda: drh5.read_dataset(f["d"]))
            stored = f["d"].id.get_storage_size()
    if not np.array_equal(got, x):
        raise AssertionError("HDF5 round trip differs")
    log(f"[7] HDF5: Nab {rows}x7000 write {tw:.2f}s read {tr:.2f}s (first "
        f"calls), ratio {stored / x.nbytes:.3f}, round trip exact")


def gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise SystemExit(f"gpu tests failed (pytest exit {int(rc)})")
    log("[8] tests marked gpu: passed")


def multi(jax, bench) -> None:
    """Chunk mesh over 4 cards against single-card compress_batch."""
    from deltarice_tpu.codec import compress_batch, frame_stream
    from deltarice_tpu.parallel import (
        chunk_mesh, decode_chunks_sharded, encode_chunks_sharded,
        roundtrip_check_step)
    from deltarice_tpu.parallel.multihost import (
        decode_chunks_multihost, encode_chunks_multihost)
    from deltarice_tpu.parallel.sharded import put_sharded

    devs = jax.devices()[:4]
    mesh = chunk_mesh(devs)
    data, cfg = bench.window("nab", seed=SEED)
    batch = np.stack(data)  # (8, 2000, 7000): 2 chunks per card
    nchunks, nseg, length = batch.shape
    nvalid = np.full((nchunks, nseg), length, np.int32)
    single = compress_batch(data, cfg)
    mw = cfg.max_words(length)
    (words, nwords), t = timed(lambda: jax.block_until_ready(
        encode_chunks_sharded(put_sharded(batch, mesh),
                              put_sharded(nvalid, mesh), cfg, mesh, mw)))
    nwords = np.asarray(nwords)
    w = int(nwords.max()) + 1
    wn = np.asarray(words[:, :, :w])
    sharded = [frame_stream(nseg * length, wn[c], nwords[c])
               for c in range(nchunks)]
    if sharded != single:
        raise AssertionError("encode_chunks_sharded bytes != compress_batch")
    out = decode_chunks_sharded(put_sharded(wn, mesh), length, cfg, mesh)
    if not np.array_equal(np.asarray(out), batch):
        raise AssertionError("decode_chunks_sharded differs from input")
    log(f"[multi] encode/decode_chunks_sharded on {len(devs)} cards: bytes "
        f"== single-card compress_batch, decode exact (first call {t:.2f}s)")
    w2, nw2, mism = roundtrip_check_step(put_sharded(batch, mesh),
                                         put_sharded(nvalid, mesh), cfg,
                                         mesh, mw)
    if int(mism) != 0 or not np.array_equal(np.asarray(nw2), nwords):
        raise AssertionError(f"roundtrip_check_step mismatches {int(mism)}")
    log("[multi] roundtrip_check_step: 0 mismatches")
    mh = encode_chunks_multihost(batch, cfg, mesh)
    if mh != single:
        raise AssertionError("encode_chunks_multihost bytes != compress_batch")
    dec = decode_chunks_multihost(single, cfg, mesh)
    if not np.array_equal(dec, batch.reshape(nchunks, -1)):
        raise AssertionError("decode_chunks_multihost differs from input")
    log("[multi] encode/decode_chunks_multihost (one process): bytes == "
        "single-card compress_batch, decode exact")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the chunk mesh over 4 cards")
    args = ap.parse_args()
    count = 4 if args.multi else 1

    build_native()
    import jax

    require_gpu(jax, count)
    log(card_line())
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_geometries as bench

    from deltarice_tpu.backend import resolve

    log(f"[3] jax {jax.__version__}; encode route {resolve('auto', 'segsum')}"
        f", decode route {resolve('auto', 'scan')} (Pallas through Triton)")
    phases = []
    if args.multi:
        phases.append(("multi", lambda: multi(jax, bench)))
    else:
        phases += [
            ("codec windows", lambda: codec_windows(bench)),
            ("golden vectors", golden_vectors),
            ("kernels vs XLA", lambda: kernels_vs_xla(bench)),
            ("hdf5", lambda: hdf5_phase(bench)),
            ("gpu tests", gpu_tests),
        ]
    for name, fn in phases:
        _, dt = timed(fn)
        log(f"phase {name}: {dt:.2f}s, peak_bytes_in_use {peak_bytes(jax)}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
