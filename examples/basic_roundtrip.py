"""Minimal write/read example — the README example of the reference,
on the device (reference: /root/reference/README.md:64-92)."""

import numpy as np
import h5py

import deltarice_tpu as drt
from deltarice_tpu import h5 as drh5


def main():
    rng = np.random.default_rng(0)
    # 100 waveforms x 7000 samples, sigma=10 noise on a random walk
    data = np.round(
        np.cumsum(rng.normal(0, 10, (100, 7000)), axis=-1)
    ).astype(np.int16)

    cfg = drt.RiceConfig(m=8, waveform_length=7000)
    with h5py.File("testFile.h5", "w") as f:
        drh5.write_dataset(f, "testData", data, cfg, chunks=(20, 7000))

    with h5py.File("testFile.h5", "r") as f:
        back = drh5.read_dataset(f["testData"])

    assert np.array_equal(back, data)
    import os

    print(
        f"ok: {data.nbytes} raw -> {os.path.getsize('testFile.h5')} in file "
        f"({os.path.getsize('testFile.h5') / data.nbytes:.1%})"
    )


if __name__ == "__main__":
    main()
