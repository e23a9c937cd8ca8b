"""Whole-frame XLA rasterizer: the G-buffer oracle.

Sequentially folds every triangle over the full frame with masked
``jnp.where`` updates — semantically identical to the reference's serial
Fill path (rasterizer.rs:2051-2073) and to the flat-queue kernel
(raster_queue.py), which must match it exactly. O(T·H·W), so it serves as
the correctness oracle for tests and the path for tiny meshes; the queue
kernel is the production path.

Depth test is strict less-than against a z-buffer cleared to 1.0
(rasterizer.rs:1704-1708); equal depth keeps the earlier triangle, making
triangle-order semantics deterministic and identical across backends.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ieee import lerp_2mad, seal_zero
from .raster_setup import TriSetup


class GBuffer(NamedTuple):
    """Per-pixel visibility: winning triangle + interpolation coordinates."""

    z: jnp.ndarray    # f32 [H, W] screen-space depth (cleared to 1.0)
    tid: jnp.ndarray  # i32 [H, W] winning triangle index, -1 = background
    b: jnp.ndarray    # f32 [H, W, 3] barycentrics (b0, b1, b2) as in the
    #                   reference: vertex weights (v0,v1,v2) <- (b1,b2,b0)


def raster_gbuffer_xla(setup: TriSetup, h: int, w: int) -> GBuffer:
    T = setup.A.shape[0]
    zz = seal_zero(setup.inv_a2)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xf = xs << 4
    yf = ys << 4

    def body(i, st):
        z, tid, b = st
        e0 = setup.A[i, 0] * xf + setup.B[i, 0] * yf + setup.C[i, 0]
        e1 = setup.A[i, 1] * xf + setup.B[i, 1] * yf + setup.C[i, 1]
        e2 = setup.A[i, 2] * xf + setup.B[i, 2] * yf + setup.C[i, 2]
        inside = (e0 | e1 | e2) >= 0
        in_box = (
            (xs >= setup.min_x[i]) & (xs < setup.max_x[i])
            & (ys >= setup.min_y[i]) & (ys < setup.max_y[i])
        )
        # Integer de-bias first, so the product is the single f32 rounding
        # (the reference's (e0x - e0add - 1) as f32 * inv_tri_a2,
        # rasterizer.rs:1695-1697).
        b0 = (e0 - setup.bias[i, 0].astype(jnp.int32)).astype(jnp.float32) \
            * setup.inv_a2[i]
        b1 = (e1 - setup.bias[i, 1].astype(jnp.int32)).astype(jnp.float32) \
            * setup.inv_a2[i]
        b2 = (e2 - setup.bias[i, 2].astype(jnp.int32)).astype(jnp.float32) \
            * setup.inv_a2[i]
        # Per-op f32 like the reference's z chain (rasterizer.rs:1704-1708)
        zi = lerp_2mad(setup.z0[i], setup.z10[i], setup.z20[i], b2, b0, zz)
        upd = setup.valid[i] & inside & in_box & (zi < z)
        z = jnp.where(upd, zi, z)
        tid = jnp.where(upd, i, tid)
        b = jnp.where(upd[..., None], jnp.stack([b0, b1, b2], axis=-1), b)
        return z, tid, b

    z0 = jnp.ones((h, w), dtype=jnp.float32)
    tid0 = jnp.full((h, w), -1, dtype=jnp.int32)
    b0 = jnp.zeros((h, w, 3), dtype=jnp.float32)
    z, tid, b = jax.lax.fori_loop(0, T, body, (z0, tid0, b0))
    return GBuffer(z=z, tid=tid, b=b)
