"""Block Barnes-Hut: the production approximate N-body step.

Array-native re-design of the reference's Barnes-Hut quadtree
(nbody.rs:186-480). The reference builds a pointer quadtree and, per
particle, opens nodes until ``s / d < theta`` (node width over distance,
nbody.rs:342-346); opened subtrees bottom out in exact pair forces.
Pointer trees and per-particle recursion are hostile to an accelerator,
so the same accuracy-vs-work dial is realized on a flat, static-shape structure:

  1. sort particles by Morton (Z-order) code — spatial locality becomes
     array locality, and EQUAL-COUNT blocks of the sorted array are
     small where the distribution is dense, exactly like quadtree leaves;
  2. per block: center of mass + AABB (the quadtree node aggregates,
     nbody.rs:300-320);
  3. NEAR FIELD (exact): for each target block, the K(theta) source
     blocks ranked WORST by the reference's own opening criterion —
     AABB distance d normalized by the source block's extent s, i.e.
     smallest d/s first — get exact pair forces, gathered block by
     block. This is the s/d < theta test (nbody.rs:342-346) applied
     blockwise: large sparse blocks (bad monopoles) are opened sooner
     than small dense ones at the same distance, and a touching block
     (d = 0) can never land in the far field;
  4. FAR FIELD (approximate): every other block contributes its monopole
     in one dense [N, B] sweep — no recursion.

theta plays its reference role through K(theta) = ceil(19 / theta^2),
matching Barnes-Hut's ~1/theta^2 work scaling in 2-D; theta == 0 must be
routed to brute force by the caller (nbody.rs:197-200), and smaller
theta strictly grows the exact set, like the reference's deeper tree
opening. The constant 19 is a measured CROSS-CALIBRATION against the
reference algorithm itself (tools/ref_oracle nbody_bh_step, an
independent C++ quadtree with the reference's exact semantics): at
theta=0.85, N=131,072 stable orbits, block=256, ground truth = oracle
brute force, relative force error is

    reference quadtree: p50 0.37%  p90 0.92%  p99 2.6%
    this kernel (K=27): p50 0.21%  p90 0.63%  p99 2.0%
    (old d-ranked K=9:  p50 1.1%   p90 6.0%   p99 31%)

i.e. at matched theta this kernel is strictly MORE accurate than the
reference's own Barnes-Hut
(tests/test_ref_oracle.py::test_oracle_bh_accuracy_class).

Force law and integration match the reference exactly: unnormalized
softened ``f = m1*m2 / (d^2 + EPS)`` (nbody.rs:164-184), explicit Euler
(nbody.rs:150-161), and the runaway-velocity kill outside 0.55 * VP_WDH
(nbody.rs:460-471). The step returns particles in Morton order —
identity is irrelevant to physics and rendering, like the reference's
per-step tree rebuild.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .nbody_forces import EPS, kill_runaway


def _morton16(ix, iy):
    """Interleave two <=15-bit ints into a (positive) int32 Z-order code."""

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(ix) | (spread(iy) << 1)


def morton_codes(px, py, x1, x2, y1, y2, bits: int = 15):
    """Z-order codes for positions against an EXPLICIT bounding box.

    Split out of morton_sort so the sharded step (parallel/nbody_shard)
    can compute codes locally from a pmin/pmax-reduced global AABB —
    min/max are exact in f32, so local codes are bit-identical to the
    gathered computation."""
    scale = (1 << bits) - 1
    ix = jnp.clip(((px - x1) / jnp.maximum(x2 - x1, 1e-12) * scale), 0, scale)
    iy = jnp.clip(((py - y1) / jnp.maximum(y2 - y1, 1e-12) * scale), 0, scale)
    return _morton16(ix.astype(jnp.int32), iy.astype(jnp.int32))


def morton_sort(px, py, m, vx=None, vy=None, bits: int = 15):
    """Sort the particle set by Z-order code; returns permuted arrays.

    A stable argsort of the codes, then one gather per array: inside the
    scanned BH step this beats one `lax.sort` carrying the payloads as
    extra operands (PERF.md)."""
    x1, x2 = jnp.min(px), jnp.max(px)
    y1, y2 = jnp.min(py), jnp.max(py)
    code = morton_codes(px, py, x1, x2, y1, y2, bits)
    vals = [px, py, m] + ([vx, vy] if vx is not None else [])
    order = jnp.argsort(code, stable=True)
    return [v[order] for v in vals]


def theta_to_k(theta: float, n_blocks: int) -> int:
    """Barnes-Hut work scaling in 2-D is ~1/theta^2; so is the exact set.

    The constant is cross-calibrated against the reference quadtree's
    measured error at matched theta (module docstring): 0.85 -> K=27.
    """
    if theta <= 0:
        raise ValueError("theta == 0 is the brute-force route")
    return max(2, min(n_blocks, int(-(-19.0 // (theta * theta)))))


def near_block_indices(x1, x2, y1, y2, k_near: int,
                       row0=None, rows: int | None = None):
    """K worst-approximated source blocks per target block.

    `rows`/`row0` (round 5, sharded BH): compute only the `rows` target
    rows starting at global block `row0` (traced OK) — the device's own
    slice of the ranking, O(rows·B) instead of the replicated O(B²)
    (VERDICT r4 #4b). Row contents are bit-identical to the same rows of
    the full table (same per-row inputs, same stable argsort).

    Ranked by squared AABB distance over the source block's squared
    diagonal — the blockwise form of the reference's s/d opening test
    (nbody.rs:342-346): at equal distance, a big sparse block (whose
    monopole is a poor stand-in) is opened before a small dense one.
    Measured at N=131k/B=512/K=27 this ranking cuts p90 force error
    2.17% -> 0.63% vs plain distance ranking at zero extra flops.

    The diagonal is forced to sort FIRST (ratio set to -1): AABB
    distance is 0 for every overlapping block and a stable argsort breaks
    ties by index, so in a dense core with > k_near zero-distance
    neighbors a high-index block could otherwise demote ITSELF to the far
    field — its particles would then feel a spurious monopole from their
    own block's COM at near-zero softened distance, which the reference
    can never produce (it skips self, nbody.rs:365). With the diagonal
    pinned, self is always in the exact near set, where i == j pairs
    contribute exactly zero.
    """
    if rows is None:
        tx1, tx2, ty1, ty2 = x1, x2, y1, y2
        r0 = jnp.int32(0)
        rows = x1.shape[0]
    else:
        r0 = jnp.asarray(row0, jnp.int32)
        tx1 = jax.lax.dynamic_slice_in_dim(x1, r0, rows, 0)
        tx2 = jax.lax.dynamic_slice_in_dim(x2, r0, rows, 0)
        ty1 = jax.lax.dynamic_slice_in_dim(y1, r0, rows, 0)
        ty2 = jax.lax.dynamic_slice_in_dim(y2, r0, rows, 0)
    ddx = jnp.maximum(0.0, jnp.maximum(x1[None, :] - tx2[:, None],
                                       tx1[:, None] - x2[None, :]))
    ddy = jnp.maximum(0.0, jnp.maximum(y1[None, :] - ty2[:, None],
                                       ty1[:, None] - y2[None, :]))
    d2 = ddx * ddx + ddy * ddy
    diag2 = (x2 - x1) ** 2 + (y2 - y1) ** 2
    ratio = d2 / jnp.maximum(diag2, 1e-12)[None, :]
    rr = jnp.arange(rows, dtype=jnp.int32)
    ratio = ratio.at[rr, r0 + rr].set(-1.0)
    return jnp.argsort(ratio, axis=1)[:, :k_near]


@partial(jax.jit, static_argnums=(3, 4))
def forces_bh_sorted(px, py, m, block: int, k_near: int):
    """Forces for MORTON-SORTED particles: K-nearest-block exact near
    field + block-monopole far field. Returns (fx, fy) with the
    reference's m1*m2 convention (fx already includes the target mass)."""
    n = px.shape[0]
    B = n // block
    assert n % block == 0 and 1 < k_near <= B

    xb = px.reshape(B, block)
    yb = py.reshape(B, block)
    mb = m.reshape(B, block)
    msum = jnp.sum(mb, axis=1)
    inv = 1.0 / jnp.maximum(msum, 1e-30)
    cx = jnp.sum(xb * mb, axis=1) * inv
    cy = jnp.sum(yb * mb, axis=1) * inv

    # Block AABB distance matrix -> K nearest neighbors per target block.
    x1 = xb.min(1); x2 = xb.max(1)
    y1 = yb.min(1); y2 = yb.max(1)
    idx = near_block_indices(x1, x2, y1, y2, k_near)  # [B, K]

    # --- near field: exact pairs, one gathered source block at a time.
    # Self-pairs (i == j inside the diagonal block) contribute exactly
    # zero: dx = dy = 0 makes the softened force direction vanish, the
    # same i != j behavior the reference gets by skipping its own tree
    # entry (nbody.rs:365).
    def body(k, acc):
        fx, fy = acc
        src = idx[:, k]
        xs = xb[src]
        ys = yb[src]
        mss = mb[src]
        dx = xs[:, None, :] - xb[:, :, None]                 # [B, tgt, src]
        dy = ys[:, None, :] - yb[:, :, None]
        r = mss[:, None, :] / (dx * dx + dy * dy + EPS)
        return fx + jnp.sum(r * dx, axis=2), fy + jnp.sum(r * dy, axis=2)

    fx, fy = jax.lax.fori_loop(
        0, k_near, body, (jnp.zeros_like(xb), jnp.zeros_like(yb)))

    # --- far field: monopoles of every block outside the near set
    nearmask = jnp.zeros((B, B), bool).at[
        jnp.arange(B, dtype=jnp.int32)[:, None], idx].set(True)
    dxf = cx[None, :] - px[:, None]                          # [N, B]
    dyf = cy[None, :] - py[:, None]
    rf = msum[None, :] / (dxf * dxf + dyf * dyf + EPS)
    rf = jnp.where(jnp.repeat(nearmask, block, axis=0), 0.0, rf)
    fx = fx.reshape(n) + jnp.sum(rf * dxf, axis=1)
    fy = fy.reshape(n) + jnp.sum(rf * dyf, axis=1)

    return fx * m, fy * m


@partial(jax.jit, static_argnums=(5, 6))
def step_bh(px, py, vx, vy, m, block: int, k_near: int, dt=0.01):
    """One Euler step: sort, block-BH forces, integrate, runaway kill.

    Returns (px, py, vx, vy, m) in Morton order. The runaway kill zeroes
    the velocity of particles beyond 0.55*VP_WDH from the origin on
    either axis, applied after the position update (nbody.rs:460-471).
    """
    px, py, m, vx, vy = morton_sort(px, py, m, vx, vy)
    fx, fy = forces_bh_sorted(px, py, m, block, k_near)
    vx = vx + dt * fx / m
    vy = vy + dt * fy / m
    px = px + dt * vx
    py = py + dt * vy
    vx, vy = kill_runaway(px, py, vx, vy)
    return px, py, vx, vy, m
