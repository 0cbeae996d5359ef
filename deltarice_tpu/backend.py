"""The one place that decides which implementation of the device layer runs.

Every encode and decode entry point (single device and mesh) asks
:func:`resolve`. The rule:

* a GPU device or mesh runs the hand-written kernels (:data:`KERNEL`,
  :mod:`.ops.pack_pallas` / :mod:`.ops.unpack_pallas`);
* a CPU device or mesh runs the plain XLA path, which is also the
  reference the kernels are tested against;
* any other platform is an error — no path is picked silently.

An explicit XLA method name (``"segsum"``/``"scatter"`` for encode,
``"scan"`` for decode) runs as asked on any platform. An explicit
:data:`KERNEL` request on a non-GPU platform is an error: the kernels never
fall into Pallas interpret mode on their own (tests opt in through the
kernel wrappers' own ``interpret`` argument).
"""

from __future__ import annotations

import jax

#: method/backend name of the GPU kernels
KERNEL = "pallas"

#: XLA method names accepted per direction
XLA_ENCODE = ("segsum", "scatter")
XLA_DECODE = ("scan",)


def platform_of(devices=None) -> str:
    """Platform of the given devices (a mesh's ``devices`` array or any
    iterable of devices), or of JAX's default backend when None."""
    if devices is None:
        return jax.default_backend()
    return next(iter(getattr(devices, "flat", devices))).platform


def resolve(choice: str, xla: str, platform: str | None = None) -> str:
    """Return the path to run: :data:`KERNEL` or an XLA method name.

    Args:
      choice: the caller's ``method``/``backend`` argument — ``"auto"``,
        :data:`KERNEL`, or an XLA method name.
      xla: the XLA method ``"auto"`` means on a CPU.
      platform: device platform; JAX's default backend when None.
    """
    platform = platform or jax.default_backend()
    if choice == "auto":
        if platform == "gpu":
            return KERNEL
        if platform == "cpu":
            return xla
        raise RuntimeError(
            f"no Delta-Rice device path for platform {platform!r}: "
            f"the kernels need a GPU, the XLA path runs on the CPU; pass an "
            f"explicit XLA method ({xla!r}) to run it elsewhere"
        )
    if choice == KERNEL:
        if platform == "gpu":
            return KERNEL
        raise ValueError(
            f"the {KERNEL!r} kernels need a GPU device, got {platform!r} "
            f"(tests call the kernel wrappers with interpret=True)"
        )
    if choice not in XLA_ENCODE + XLA_DECODE:
        raise ValueError(f"unknown codec method {choice!r}")
    return choice
