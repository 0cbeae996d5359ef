"""Command-line interface.

Covers the reference's user-facing workflows (README examples, the C
example program, the documented optimization routine) as subcommands:

    python -m deltarice_tpu info FILE.h5
    python -m deltarice_tpu compress SRC.h5 DST.h5 [--dataset D] [--m M]
        [--wavelength L] [--chunk-rows R] [--filter a,b,...]
    python -m deltarice_tpu decompress SRC.h5 DST.h5 [--dataset D]
    python -m deltarice_tpu optimize FILE.h5 [--dataset D] [--taps N]

(Throughput benchmarking lives in the repo-root ``bench.py``.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import __version__
from .config import H5FILTER, RiceConfig


def _open(path, mode="r"):
    import h5py

    return h5py.File(path, mode)


def _datasets(f):
    names = []
    f.visititems(
        lambda n, o: names.append(n) if hasattr(o, "shape") else None
    )
    return names


def _pick_dataset(f, name):
    if name:
        return f[name]
    names = _datasets(f)
    if len(names) != 1:
        raise SystemExit(
            f"--dataset required; file has {len(names)} datasets: {names}"
        )
    return f[names[0]]


def cmd_info(args):
    from . import h5 as drh5

    with _open(args.file) as f:
        for name in _datasets(f):
            dset = f[name]
            try:
                cfg = drh5.dataset_config(dset)
                desc = (
                    f"deltarice M={cfg.m} L={cfg.waveform_length} "
                    f"filter={list(cfg.filt)}"
                )
            except ValueError:
                desc = dset.compression or "uncompressed"
            stored = dset.id.get_storage_size()
            raw = dset.nbytes
            ratio = f"{stored / raw:.1%}" if raw else "-"
            print(
                f"{name}: shape={dset.shape} dtype={dset.dtype} "
                f"chunks={dset.chunks} [{desc}] stored={stored} ({ratio})"
            )


def cmd_compress(args):
    from . import h5 as drh5

    filt = (
        tuple(int(v) for v in args.filter.split(","))
        if args.filter
        else (1, -1)
    )
    with _open(args.src) as fs, _open(args.dst, "w") as fd:
        dset = _pick_dataset(fs, args.dataset)
        length = args.wavelength or (
            dset.shape[-1] if dset.ndim == 2 else -1
        )
        cfg = RiceConfig(args.m, length, filt)
        chunks = None
        if dset.ndim == 2:
            rows = args.chunk_rows or min(dset.shape[0], 32)
            chunks = (min(rows, dset.shape[0]), dset.shape[1])
        t0 = time.time()
        # the source dataset streams window-by-window through
        # write_dataset — multi-GB inputs never materialize in host RAM
        out = drh5.write_dataset(
            fd, args.dataset or dset.name.lstrip("/"), dset, cfg, chunks
        )
        dt = time.time() - t0
        stored = out.id.get_storage_size()
        print(
            f"compressed {dset.nbytes} -> {stored} bytes "
            f"({stored / dset.nbytes:.1%}) in {dt:.2f}s "
            f"({dset.nbytes / dt / 1e6:.0f} MB/s)"
        )


def cmd_decompress(args):
    from . import h5 as drh5

    with _open(args.src) as fs, _open(args.dst, "w") as fd:
        dset = _pick_dataset(fs, args.dataset)
        out = fd.create_dataset(
            args.dataset or dset.name.lstrip("/"), shape=dset.shape,
            dtype=dset.dtype, chunks=dset.chunks,
        )
        shape, chunk_shape = dset.shape, dset.chunks
        t0 = time.time()
        # stream chunk windows: constant host memory for any dataset size
        for off, block in drh5.iter_chunks(dset):
            sel = tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(off, chunk_shape, shape)
            )
            out[sel] = block[
                tuple(slice(0, s.stop - s.start) for s in sel)
            ]
        dt = time.time() - t0
        print(
            f"decompressed {dset.nbytes} bytes in {dt:.2f}s "
            f"({dset.nbytes / dt / 1e6:.0f} MB/s)"
        )


def cmd_optimize(args):
    from . import optimize as opt
    from . import h5 as drh5

    with _open(args.file) as f:
        dset = _pick_dataset(f, args.dataset)
        rows = min(dset.shape[0], args.sample_rows) if dset.ndim == 2 else 1
        data = dset[:rows] if dset.ndim == 2 else dset[()]
    data = np.asarray(data).astype(np.int16)
    cfg = opt.optimize(data, n_taps=args.taps, span=args.span)
    bits = opt.expected_bits(data, cfg.m, cfg.filt)
    print(
        json.dumps(
            {
                "m": cfg.m,
                "filter": list(cfg.filt),
                "expected_bits_per_sample": round(bits, 3),
                "expected_ratio": round(bits / 16.0, 4),
                "cd_values_prefix": [cfg.m],
            }
        )
    )


def cmd_install_plugin(args):
    from .native.install import install_plugin

    print(f"installed {install_plugin(args.plugin_dir, verbose=True)}")


def cmd_warmup(args):
    from .utils.warmup import warmup

    warmup(cfg=RiceConfig(args.m, args.wavelength), nseg=args.segments,
           verbose=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="deltarice_tpu",
        description=f"Delta-Rice codec v{__version__} "
        f"(HDF5 filter {H5FILTER})",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="describe datasets in an HDF5 file")
    pi.add_argument("file")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("compress", help="compress a dataset into a new file")
    pc.add_argument("src")
    pc.add_argument("dst")
    pc.add_argument("--dataset")
    pc.add_argument("--m", type=int, default=8)
    pc.add_argument("--wavelength", type=int)
    pc.add_argument("--chunk-rows", type=int)
    pc.add_argument("--filter", help="comma-separated taps, e.g. 1,-1")
    pc.set_defaults(fn=cmd_compress)

    pd = sub.add_parser("decompress", help="decompress into a plain file")
    pd.add_argument("src")
    pd.add_argument("dst")
    pd.add_argument("--dataset")
    pd.set_defaults(fn=cmd_decompress)

    po = sub.add_parser("optimize", help="suggest (M, filter) for a dataset")
    po.add_argument("file")
    po.add_argument("--dataset")
    po.add_argument("--taps", type=int, default=2)
    po.add_argument("--span", type=int, default=1)
    po.add_argument("--sample-rows", type=int, default=64)
    po.set_defaults(fn=cmd_optimize)

    pp = sub.add_parser(
        "install-plugin",
        help="build the native filter and copy it into an HDF5 plugin "
        "directory so any HDF5 app auto-loads it (reference parity: "
        "setup.py install --h5plugin)",
    )
    pp.add_argument("--plugin-dir", default=None)
    pp.set_defaults(fn=cmd_install_plugin)

    pw = sub.add_parser(
        "warmup",
        help="pre-compile the codec's device programs for one geometry so "
        "the first production call is warm (persistent cache)",
    )
    pw.add_argument("--m", type=int, default=8)
    pw.add_argument("--wavelength", type=int, default=7000)
    pw.add_argument("--segments", type=int, default=1024)
    pw.set_defaults(fn=cmd_warmup)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
