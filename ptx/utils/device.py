"""Which device work runs on.

Every timing this repository reports names its card: the platform and
device kind JAX sees, and the card's name and power limit as
``nvidia-smi`` reports them (a card capped below its maximum power runs
slower under load).  A measurement path that finds no GPU fails; it does
not fall back to the CPU.

Scene building runs on the host CPU: builders and ``compile_scene`` are
chains of small eager ops, each of which on a GPU is a kernel launch
with a compile of its own (demo scene build 1.1 s on the host vs 2.6 s
on an H100, PERF.md).
"""

from __future__ import annotations

import contextlib
import functools
import subprocess


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``: one ``name, limit``
    line per card, or ``"nvidia-smi unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip()


def require_gpu() -> dict:
    """The JAX device summary ``{platform, kind, count}``; raises
    ``SystemExit`` unless JAX's default devices are GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default devices are "
                         f"{devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def host_default_device():
    """Context manager: the host CPU as JAX's default device (a no-op
    context where the process has no CPU backend)."""
    import jax
    try:
        return jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:
        return contextlib.nullcontext()


def on_host(fn):
    """Decorator: run ``fn`` under :func:`host_default_device`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with host_default_device():
            return fn(*args, **kwargs)
    return wrapped
