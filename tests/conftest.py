import os

import pytest

# Give the CPU backend 8 virtual devices so mesh/sharding tests have a
# multi-device platform everywhere (tests pick them via jax.devices("cpu")).
# The platform itself is the caller's choice: JAX_PLATFORMS=cpu for the CPU
# suite; on a GPU host, `python -m pytest -m gpu` runs the card-only cases.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Cases marked ``gpu`` run the compiled kernels at real widths; they
    skip unless JAX's default backend is a GPU. Decided here, at run time,
    never while test modules are imported."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
