"""Brute-force N-body forces as a Pallas kernel (Triton route).

Math identical to nbody_forces (reference nbody.rs:164-184):
f_vec(i<-j) = m_i m_j (p_j - p_i) / (d^2 + EPS), explicit Euler.

One program per tile of T_TILE targets, looping over the sources in
chunks of S_CHUNK with the two force accumulators in registers: each
chunk forms its [S, T] pair tile, reduces it over the sources at once,
and adds the result to the accumulators. The self-pair is exactly zero
(dx == 0, the reference's i != j skip algebraically), so no mask is
needed. The target mass multiplies once at the end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .nbody_forces import EPS

T_TILE = 128   # targets per program
S_CHUNK = 32   # sources per loop step: a [32, 128] pair tile per step
NUM_WARPS = 4


def supported(n: int) -> bool:
    """The kernel needs N to be a power of two of at least T_TILE (every
    block shape on the Triton route is a power of two)."""
    return n >= T_TILE and n & (n - 1) == 0


def _kernel(xs_ref, ys_ref, ms_ref, xt_ref, yt_ref, fx_ref, fy_ref, *,
            n: int, s_chunk: int):
    xt = xt_ref[...]        # [T] targets
    yt = yt_ref[...]

    def body(j, acc):
        fx, fy = acc
        src = pl.ds(j * s_chunk, s_chunk)
        xs = xs_ref[src]    # [S] sources
        ys = ys_ref[src]
        ms = ms_ref[src]
        dx = xs[:, None] - xt[None, :]          # [S, T]
        dy = ys[:, None] - yt[None, :]
        r = ms[:, None] / (dx * dx + dy * dy + EPS)
        return fx + jnp.sum(r * dx, axis=0), fy + jnp.sum(r * dy, axis=0)

    zero = jnp.zeros(xt.shape, jnp.float32)
    fx, fy = lax.fori_loop(0, n // s_chunk, body, (zero, zero))
    fx_ref[...] = fx
    fy_ref[...] = fy


@partial(jax.jit, static_argnames=("interpret",))
def forces_pallas(px, py, m, interpret: bool | None = None):
    """All-pairs forces (fx, fy) with the reference's m_i m_j convention.

    `interpret=None` asks core.platform.kernel_mode (compiled on a GPU,
    the Pallas interpreter on the CPU). N must satisfy `supported`."""
    from ..core.platform import use_interpret

    n = px.shape[0]
    if not supported(n):
        raise ValueError(f"N={n} is not a power of two >= {T_TILE}")
    whole = pl.no_block_spec
    tgt = pl.BlockSpec((T_TILE,), lambda i: (i,))
    fx, fy = pl.pallas_call(
        partial(_kernel, n=n, s_chunk=S_CHUNK),
        grid=(n // T_TILE,),
        in_specs=[whole, whole, whole, tgt, tgt],
        out_specs=(tgt, tgt),
        out_shape=(jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.float32)),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=2),
        interpret=use_interpret(interpret),
        name="nbody_forces",
    )(px, py, m, px, py)
    return fx * m, fy * m


@jax.jit
def step_brute_pallas(px, py, vx, vy, m, dt=0.01):
    """Euler step on the kernel's forces (nbody.rs:150-161 semantics)."""
    fx, fy = forces_pallas(px, py, m)
    vx = vx + dt * fx / m
    vy = vy + dt * fy / m
    px = px + dt * vx
    py = py + dt * vy
    return px, py, vx, vy
