"""Platform decisions, made in one place.

Every kernel and shard module asks ``kernel_mode`` whether its kernels
compile for the device or run in the Pallas interpreter; the entry points
call ``enable_compile_cache`` once; ``strict_ieee_default`` decides whether
f32 interpolation is sealed against FMA contraction (ops/ieee.py).
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]

# jax names CUDA devices "gpu" (jax.default_backend(), Device.platform)
_COMPILED = ("gpu", "cuda")


def kernel_mode(platform: str | None = None) -> str:
    """"compiled" on a GPU, "interpret" on the CPU; any other platform raises.

    `platform` defaults to the process's default backend; mesh code passes
    its devices' platform so a CPU mesh in a GPU process still interprets.
    """
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform in _COMPILED:
        return "compiled"
    if platform == "cpu":
        return "interpret"
    raise RuntimeError(
        f"no kernel path for platform {platform!r}: kernels compile for "
        "an NVIDIA GPU and run in the Pallas interpreter on the CPU")


def use_interpret(interpret: bool | None = None,
                  platform: str | None = None) -> bool:
    """The `interpret=` flag for a Pallas call: an explicit value wins,
    None asks kernel_mode."""
    if interpret is not None:
        return bool(interpret)
    return kernel_mode(platform) == "interpret"


def strict_ieee_default() -> bool:
    """Whether f32 products are sealed against FMA contraction.

    On by default on every platform: the seals make the CPU oracle chain
    and the GPU frames round per operation like the reference (see
    ops/ieee.py). RUSTEXP_STRICT_IEEE=0/1 overrides.
    """
    env = os.environ.get("RUSTEXP_STRICT_IEEE")
    if env is not None:
        return env not in ("0", "false", "")
    return True


def _host_key() -> str:
    """Hash of the host's machine type and CPU flags.

    XLA:CPU executables embed the host's CPU features; a cache filled on
    other hardware warns on load and can change float codegen, so the
    default cache directory is keyed by them."""
    import hashlib
    import platform as _plat

    try:
        with open("/proc/cpuinfo") as f:
            flags = "".join(line for line in f if line.startswith("flags"))
    except OSError:
        flags = ""
    return hashlib.sha1((_plat.machine() + flags).encode()).hexdigest()[:10]


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache/<host>."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(_REPO / ".jax_cache" / _host_key())


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    d = compile_cache_dir()
    if jax.config.jax_compilation_cache_dir != d:
        jax.config.update("jax_compilation_cache_dir", d)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return d
