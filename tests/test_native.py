"""Native C filter plugin: registration, H5Z pipeline round trips, and
byte-level equivalence against both the device codec and the reference C
implementation."""

import numpy as np
import pytest

import deltarice_tpu as drt
from deltarice_tpu import native
from deltarice_tpu.testing.oracle import ReferenceOracle, oracle_available

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def registered():
    if not native.register_with_h5py():
        pytest.skip("native filter could not be built/registered")
    return True


def _data(shape=(12, 600), seed=0):
    rng = np.random.default_rng(seed)
    return np.round(
        np.cumsum(rng.normal(0, 10, shape), axis=-1)
    ).astype(np.int16)


def test_pipeline_roundtrip(registered, tmp_path):
    x = _data()
    with h5py.File(tmp_path / "n.h5", "w") as f:
        f.create_dataset(
            "d", data=x, chunks=(4, 600), compression=drt.H5FILTER,
            compression_opts=(8, 600), allow_unknown_filter=True,
        )
    with h5py.File(tmp_path / "n.h5", "r") as f:
        np.testing.assert_array_equal(f["d"][()], x)


def test_native_bytes_match_device_codec(registered, tmp_path):
    """Chunks written through the C filter pipeline must be byte-identical
    to the device encoder's output for the same chunk + config."""
    x = _data((8, 512), seed=1)
    cfg = drt.RiceConfig(8, 512)
    with h5py.File(tmp_path / "n.h5", "w") as f:
        f.create_dataset(
            "d", data=x, chunks=(4, 512), compression=drt.H5FILTER,
            compression_opts=cfg.to_cd_values(), allow_unknown_filter=True,
        )
    with h5py.File(tmp_path / "n.h5", "r") as f:
        for row in (0, 4):
            _m, blob = f["d"].id.read_direct_chunk((row, 0))
            assert blob == drt.compress(x[row : row + 4], cfg)


@pytest.mark.skipif(not oracle_available(), reason="no reference oracle")
def test_native_bytes_match_reference(registered):
    """ctypes-level: dr_compress output == reference C filter output."""
    x = _data((1, 2000), seed=2).ravel()
    cfg = drt.RiceConfig(16, 500)
    blob = native.native_compress(x, cfg.to_cd_values())

    oracle = ReferenceOracle()
    assert blob == oracle.compress(x, cfg.to_cd_values())
    assert blob == drt.compress(x, cfg)


def test_reference_file_reads_through_native(registered, tmp_path):
    """File written by the device path reads back through the C filter."""
    from deltarice_tpu import h5 as drh5

    x = _data((10, 300), seed=3)
    cfg = drt.RiceConfig(8, 300)
    with h5py.File(tmp_path / "x.h5", "w") as f:
        drh5.write_dataset(f, "d", x, cfg, chunks=(5, 300))
    with h5py.File(tmp_path / "x.h5", "r") as f:
        np.testing.assert_array_equal(f["d"][()], x)  # H5Z pipeline read
