"""N-body force kernels.

Force law parity with the reference (nbody.rs:164-184): softened gravity
with *unnormalized* direction vector,

    f_vec(i<-j) = m_i * m_j * (p_j - p_i) / (|p_j - p_i|^2 + EPS)

(note: ~1/r falloff, not 1/r^2 — the reference's TODO acknowledges this; we
preserve it exactly for trajectory parity), EPS = 1e-4 (nbody.rs:17), and
explicit-Euler integration v += dt*f/m; p += dt*v (nbody.rs:150-161).

The reference's brute force is a serial O(N^2) double loop; the threaded
Barnes-Hut path fans particle slices out to threads over a shared quadtree
(nbody.rs:424-478). Array-native equivalents:

  * forces_dense    — one [N, N] broadcast; oracle for small N.
  * forces_blocked  — lax.scan over target blocks, inner scan over source
                      blocks: O(N^2) FLOPs, O(B^2) memory.
  * block Barnes-Hut — see nbody_bh.py (the production approximate path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

EPS = 1e-4  # softening, nbody.rs:17


def _pair_forces(px_t, py_t, m_t, px_s, py_s, m_s, self_mask=None):
    """Forces on targets [T] from sources [S]; returns (fx[T], fy[T])."""
    dx = px_s[None, :] - px_t[:, None]
    dy = py_s[None, :] - py_t[:, None]
    d2 = dx * dx + dy * dy + EPS
    f = (m_t[:, None] * m_s[None, :]) / d2
    if self_mask is not None:
        f = jnp.where(self_mask, 0.0, f)
    return jnp.sum(f * dx, axis=1), jnp.sum(f * dy, axis=1)


@jax.jit
def forces_dense(px, py, m):
    """All-pairs forces with i==j excluded; materializes [N, N]."""
    n = px.shape[0]
    eye = jnp.eye(n, dtype=bool)
    return _pair_forces(px, py, m, px, py, m, self_mask=eye)


@partial(jax.jit, static_argnums=(3,))
def forces_blocked(px, py, m, block: int = 1024):
    """Blocked all-pairs: target blocks scanned, sources chunked inside.

    i==j exclusion by global index comparison. N must be padded to a
    multiple of `block` by the caller (pad with m=0 particles at inf).
    """
    n = px.shape[0]
    assert n % block == 0, "pad particle count to a multiple of block"
    nb = n // block
    idx = jnp.arange(n)

    pxb = px.reshape(nb, block)
    pyb = py.reshape(nb, block)
    mb = m.reshape(nb, block)
    ib = idx.reshape(nb, block)

    def target_body(carry, tgt):
        px_t, py_t, m_t, i_t = tgt

        def source_body(acc, src):
            px_s, py_s, m_s, i_s = src
            fx_acc, fy_acc = acc
            mask = i_t[:, None] == i_s[None, :]
            fx, fy = _pair_forces(px_t, py_t, m_t, px_s, py_s, m_s, self_mask=mask)
            return (fx_acc + fx, fy_acc + fy), None

        (fx, fy), _ = lax.scan(
            source_body,
            (jnp.zeros(block), jnp.zeros(block)),
            (pxb, pyb, mb, ib),
        )
        return carry, (fx, fy)

    _, (fx, fy) = lax.scan(target_body, None, (pxb, pyb, mb, ib))
    return fx.reshape(n), fy.reshape(n)


@partial(jax.jit, static_argnums=(5,))
def step_brute_force(px, py, vx, vy, m, block: int = 0, dt: float = 0.01):
    """One Euler step (nb_step_brute_force, nbody.rs:106-162)."""
    if block and px.shape[0] % block == 0 and px.shape[0] > block:
        fx, fy = forces_blocked(px, py, m, block)
    else:
        fx, fy = forces_dense(px, py, m)
    vx = vx + dt * fx / m
    vy = vy + dt * fy / m
    px = px + dt * vx
    py = py + dt * vy
    return px, py, vx, vy


def kill_runaway(px, py, vx, vy, vp_wdh=100.0, vp_org=(0.0, 0.0)):
    """Zero velocity outside 0.55*viewport (reference hack, nbody.rs:460-471)."""
    out = (jnp.abs(vp_org[0] - px) > vp_wdh * 0.55) | (
        jnp.abs(vp_org[1] - py) > vp_wdh * 0.55
    )
    return jnp.where(out, 0.0, vx), jnp.where(out, 0.0, vy)
