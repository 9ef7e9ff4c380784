"""Where the program runs: the persistent compile cache, the GPU check, and
the card's identity for measurement records.

The wave is statically unrolled per bounce, per light and per shape kind
(models/integrators.py), so its first compile is a large part of a cold
run. XLA's persistent cache keeps compiled programs across processes.
"""
from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, nothing is
    changed here. Otherwise the cache lives at the fixed path
    <checkout>/.jax_cache (gitignored)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu() -> None:
    """Raise RuntimeError unless JAX's default backend is a GPU. A run that
    asked for the GPU never carries on on the CPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")


def describe_devices() -> dict:
    """{"platform", "kind", "count"} of the devices JAX runs on."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s "name, power.limit" line(s) for the visible cards. A
    card set below its maximum power runs slower under load, so every
    timing is recorded beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
