"""Real multi-process `jax.distributed` validation (SURVEY §4).

Spawns 2 worker processes forming a CPU `jax.distributed` cluster (gloo
collectives, 4 virtual devices each) and runs the full multihost pipeline:
sharded encode -> process_allgather -> frame on process 0, then the
read-side decode pipeline — asserting byte equality with the single-device
codec. This executes the `jax.process_count() > 1` branches of
deltarice_tpu/parallel/multihost.py for real, not as dead code.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

_REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_multihost_pipeline(tmp_path):
    port = _free_port()
    env = {
        "PATH": os.environ.get("PATH", ""),
        "HOME": os.environ.get("HOME", "/tmp"),
        # CPU-only cluster: the workers import only this checkout
        "PYTHONPATH": str(_REPO),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "DELTARICE_TPU_CACHE": "0",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(_REPO / "tests" / "mp_worker.py"),
             str(pid), "2", str(port), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    assert (tmp_path / "SUCCESS").exists(), "process 0 never wrote SUCCESS"
