"""The one backend decision (:func:`deltarice_tpu.backend.resolve`) and the
entry points that consult it."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deltarice_tpu as drt
from deltarice_tpu import backend
from deltarice_tpu.backend import KERNEL, platform_of, resolve


@pytest.mark.parametrize("xla", ["segsum", "scan"])
def test_auto_on_gpu_picks_kernel(xla):
    assert resolve("auto", xla, "gpu") == KERNEL


@pytest.mark.parametrize("xla", ["segsum", "scan"])
def test_auto_on_cpu_picks_xla(xla):
    assert resolve("auto", xla, "cpu") == xla


@pytest.mark.parametrize("platform", ["neuron", "metal"])
def test_auto_on_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no Delta-Rice device path"):
        resolve("auto", "segsum", platform)


def test_explicit_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="need a GPU"):
        resolve(KERNEL, "segsum", "cpu")


@pytest.mark.parametrize("xla", ["segsum", "scan"])
def test_explicit_kernel_on_gpu_picks_kernel(xla):
    assert resolve(KERNEL, xla, "gpu") == KERNEL


@pytest.mark.parametrize("platform", ["neuron", "metal"])
def test_explicit_kernel_off_gpu_raises(platform):
    with pytest.raises(ValueError, match="need a GPU"):
        resolve(KERNEL, "scan", platform)


@pytest.mark.parametrize("method", ["segsum", "scatter", "scan"])
def test_explicit_xla_method_runs_on_any_platform(method):
    for platform in ("cpu", "gpu", "neuron"):
        assert resolve(method, "segsum", platform) == method


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown codec method"):
        resolve("mosaic", "segsum", "cpu")


def test_platform_of_devices_and_default():
    assert platform_of(jax.devices("cpu")) == "cpu"
    assert platform_of(np.asarray(jax.devices("cpu")[:2])) == "cpu"
    assert platform_of() == jax.default_backend()


def _walk(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, 10, shape), axis=-1)).astype(
        np.int16
    )


@pytest.mark.parametrize("entry", [
    "compress", "compress_batch", "decompress", "decompress_batch",
    "encode_segments", "decode_segments", "sharded_encode",
])
def test_entry_points_refuse_kernel_on_cpu(entry):
    """Every path asks the one decision: an explicit kernel request on a
    CPU device is an error, never a silent fallback or interpret mode."""
    if jax.default_backend() != "cpu":
        pytest.skip("checks the CPU refusal")
    from deltarice_tpu import codec
    from deltarice_tpu.parallel import chunk_mesh, encode_chunks_sharded

    cfg = drt.RiceConfig(8, 64)
    x = _walk((4, 64))
    blob = drt.compress(x, cfg)
    calls = {
        "compress": lambda: drt.compress(x, cfg, method=KERNEL),
        "compress_batch": lambda: codec.compress_batch([x, x], cfg, KERNEL),
        "decompress": lambda: drt.decompress(blob, cfg, backend=KERNEL),
        "decompress_batch": lambda: codec.decompress_batch([blob], cfg,
                                                           KERNEL),
        "encode_segments": lambda: drt.encode_segments(
            jnp.asarray(x), jnp.full(4, 64, jnp.int32), cfg,
            cfg.max_words(64), KERNEL),
        "decode_segments": lambda: drt.decode_segments(
            jnp.zeros((4, 256), jnp.uint32), 64, cfg, KERNEL),
        "sharded_encode": lambda: encode_chunks_sharded(
            jnp.asarray(x[None]), jnp.full((1, 4), 64, jnp.int32), cfg,
            chunk_mesh(jax.devices("cpu")[:1]), cfg.max_words(64), KERNEL),
    }
    with pytest.raises(ValueError, match="need a GPU"):
        calls[entry]()


def test_xla_names_are_the_only_non_kernel_methods():
    assert set(backend.XLA_ENCODE) == {"segsum", "scatter"}
    assert backend.XLA_DECODE == ("scan",)
