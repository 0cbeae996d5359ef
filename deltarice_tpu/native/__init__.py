"""Native (C) interop components.

The reference's HDF5-facing adapters are native C (`H5Z` filter class,
dynamic plugin shim, dlopen symbol loader — ``/root/reference/src/
deltaRice.c:468-501``, ``deltaRice_h5plugin.c``, ``hdf5_dl.c``). This package
holds this framework's equivalents: a from-scratch C implementation of
the Delta-Rice filter (ID 32025) that registers into the process's HDF5 so
*any* HDF5 application — including plain h5py without this package's direct-
chunk path — can read and write our files through the standard filter
pipeline.

Build: ``python -m deltarice_tpu.native build`` (or ``make -C
deltarice_tpu/native``). The shared library lands in
``deltarice_tpu/native/lib/``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

def library_path() -> Path:
    from ._build import _LIB  # platform-dependent name (.so/.dylib/.dll)

    return _LIB


def is_built() -> bool:
    """True when the library exists and is no older than its sources
    (a stale build would load without newly added exports and silently
    disable every native helper — see :func:`codec_lib`)."""
    lib = library_path()
    if not lib.is_file():
        return False
    try:
        built = lib.stat().st_mtime
        src = Path(__file__).parent / "src"
        return all(built >= p.stat().st_mtime for p in src.glob("*.[ch]"))
    except OSError:
        return True  # unreadable source tree (installed wheel): trust it


def build(verbose: bool = False) -> Path:
    """Compile the native filter library (idempotent)."""
    from ._build import build_library

    return build_library(verbose=verbose)


_codec_lib: "ctypes.CDLL | None | bool" = False  # False = not yet tried


def codec_lib() -> "ctypes.CDLL | None":
    """The native codec library for host-side helpers (header walk,
    ragged gather), or None if it isn't built and can't be. Cached."""
    global _codec_lib
    if _codec_lib is False:
        lib = None
        if is_built() or _try_build():
            try:
                lib = ctypes.CDLL(str(library_path()))
                lib.dr_walk_headers.restype = ctypes.c_int
                lib.dr_walk_headers.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.dr_gather_rows.restype = None
                lib.dr_gather_rows.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ]
                lib.dr_merge_substreams.restype = None
                lib.dr_merge_substreams.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                    ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p,
                ]
                lib.dr_config_parse.restype = ctypes.c_int
                lib.dr_compress.restype = ctypes.c_int
                lib.dr_frame_rows.restype = None
                lib.dr_frame_rows.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                    ctypes.c_void_p,
                ]
            except (OSError, AttributeError):
                lib = None  # stale library without the helpers
        _codec_lib = lib
    return _codec_lib


class _DrConfig(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_uint32), ("k", ctypes.c_int),
        ("seg_len", ctypes.c_int64),
        ("filt", ctypes.c_void_p), ("filt_len", ctypes.c_size_t),
    ]


def native_compress(samples, cd_values) -> bytes:
    """Compress one chunk of int16 samples with the native C codec's
    ``dr_compress`` (an implementation independent of the device path,
    so tests and the card smoke run compare against it byte for byte)."""
    import numpy as np

    lib = codec_lib()
    if lib is None:
        raise RuntimeError("native codec library is not built")
    x = np.ascontiguousarray(samples, dtype=np.int16).ravel()
    cd = [int(v) & 0xFFFFFFFF for v in cd_values]
    cd_arr = (ctypes.c_uint * max(len(cd), 1))(*cd)
    cfg = _DrConfig()
    if lib.dr_config_parse(len(cd), cd_arr, ctypes.byref(cfg)) != 0:
        raise ValueError(f"invalid cd_values {cd}")
    out = ctypes.c_void_p()
    nwords = ctypes.c_size_t()
    try:
        rc = lib.dr_compress(x.ctypes.data_as(ctypes.c_void_p), x.size,
                             ctypes.byref(cfg), ctypes.byref(out),
                             ctypes.byref(nwords))
        if rc != 0:
            raise RuntimeError(f"dr_compress failed ({rc})")
        blob = ctypes.string_at(out.value, nwords.value * 4)
    finally:
        if out.value:
            _libc_free(out)
        lib.dr_config_free(ctypes.byref(cfg))
    return blob


def _libc_free(ptr) -> None:
    libc = ctypes.CDLL(None)
    libc.free.argtypes = [ctypes.c_void_p]
    libc.free(ptr)


def _try_build() -> bool:
    try:
        build()
    except Exception:
        return False
    return True


def register_with_h5py() -> bool:
    """Load the native filter and register it into h5py's HDF5.

    The C library resolves HDF5 symbols from the already-loaded h5py
    extension modules at runtime (same design point as the reference's
    ``hdf5_dl.c:194-267``, re-implemented from scratch), so no HDF5
    development install is needed. Returns True if registration succeeded.
    """
    if not is_built():
        try:
            build()
        except Exception:
            return False
    try:
        import h5py  # ensures libhdf5 symbols are present in the process
    except ImportError:
        return False
    try:
        lib = ctypes.CDLL(str(library_path()), mode=ctypes.RTLD_GLOBAL)
        for hdf5 in _candidate_hdf5_libs(h5py):
            if lib.dr_h5_init_from(hdf5.encode()) == 0:
                break
        rc = lib.deltarice_tpu_register()
        return rc >= 0
    except OSError:
        return False


def _candidate_hdf5_libs(h5py) -> list[str]:
    """Shared libraries that may export the HDF5 API in an h5py install:
    the wheel-bundled libhdf5 (manylinux ``h5py.libs``) or, for
    system-linked builds, h5py's own extension modules (which re-export
    through their DT_NEEDED libhdf5)."""
    import glob

    root = Path(h5py.__file__).resolve().parent
    cands: list[str] = []
    for pat in ("../h5py.libs/libhdf5*.so*", "../h5py.libs/libhdf5*"):
        cands.extend(sorted(glob.glob(str(root / pat))))
    cands.extend(sorted(glob.glob(str(root / "defs*.so"))))
    cands.extend(sorted(glob.glob(str(root / "h5z*.so"))))
    return cands
