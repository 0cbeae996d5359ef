"""Chunk-parallel encoding over a device mesh (single- or multi-host).

Run anywhere; on a CPU-only machine expose a virtual mesh first:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/sharded_encode.py
"""

import numpy as np
import jax

import deltarice_tpu as drt
from deltarice_tpu.parallel import chunk_mesh
from deltarice_tpu.parallel.multihost import encode_chunks_multihost


def main():
    devices = jax.devices()
    mesh = chunk_mesh(devices)
    print(f"mesh: {mesh.devices.size} x {devices[0].platform}")

    rng = np.random.default_rng(0)
    batch = np.round(
        np.cumsum(rng.normal(0, 10, (16, 8, 1024)), axis=-1)
    ).astype(np.int16)  # 16 chunks x 8 segments x 1024 samples
    cfg = drt.RiceConfig(8, 1024)

    blobs = encode_chunks_multihost(batch, cfg, mesh)
    if blobs is not None:  # writer process
        total = sum(len(b) for b in blobs)
        print(f"ok: {batch.nbytes} raw -> {total} compressed "
              f"({total / batch.nbytes:.1%}) across {len(blobs)} chunks")
        assert blobs[0] == drt.compress(batch[0].ravel(), cfg)


if __name__ == "__main__":
    main()
