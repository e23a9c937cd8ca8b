"""CUDA kernels called through jax.ffi: build, load, register, call.

Sources live in ops/cuda/*.cu. Each is compiled for sm_90a (Hopper) with
nvcc into <checkout>/build/cuda/ (listed in .gitignore) the first time it
is used, or ahead of time with

    python -m rustexp_tpu.ops.cuda_ffi

The library name carries a hash of its source, so an edited kernel
rebuilds and a stale library is never loaded. CUDA code has no interpret
mode: on the CPU the callers run their plain jnp twins instead
(core.platform.kernel_mode).
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "cuda"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "cuda"

# source name -> (FFI target name, handler symbol)
_TARGETS = {"gol_swar": ("rustexp_gol_swar", "RustexpGolSwar")}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (CUDA toolkit needed to build "
                           "the GPU kernels)")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1((_SRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ops/cuda/<name>.cu into a shared library, once."""
    import fcntl

    import jax.ffi

    out = library_path(name)
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(".tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", jax.ffi.include_dir(), "-o", str(tmp),
               str(_SRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{res.stderr}")
        os.replace(tmp, out)
    return out


@functools.cache
def _target(name: str) -> str:
    import ctypes

    import jax.ffi

    lib = ctypes.cdll.LoadLibrary(str(build(name)))
    target, symbol = _TARGETS[name]
    jax.ffi.register_ffi_target(target, jax.ffi.pycapsule(getattr(lib, symbol)),
                                platform="CUDA")
    return target


def gol_swar(packed, k: int, plan):
    """k SWAR generations of a packed [W, C] uint32 grid by the CUDA
    kernel, tiled as `plan` (ops/gol_bits.Plan) says."""
    import jax
    import jax.numpy as jnp

    shape = jax.ShapeDtypeStruct(packed.shape, jnp.uint32)
    out, _scratch = jax.ffi.ffi_call(
        _target("gol_swar"), (shape, shape), vmap_method="sequential")(
        packed, gens=np.int64(k), bw=np.int64(plan.bw), cw=np.int64(plan.cw),
        kk=np.int64(plan.kk))
    return out


if __name__ == "__main__":
    for name in _TARGETS:
        print(build(name))
