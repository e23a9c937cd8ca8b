"""Per-triangle rasterization setup, batched over the whole mesh.

Array-native re-expression of the per-triangle preamble of the reference's
scanline rasterizer (rasterizer.rs:1545-1634): 28.4 fixed-point vertex snap,
backface cull via the 2·area cross product, bottom-left fill-convention
biases folded into the edge-function constants, and the pixel AABB — all
computed for every triangle at once as int32/float32 vector ops instead of
per-triangle scalar code.

Fixed-point conventions preserved exactly (they matter for golden-image
parity): truncating ``* 16.0 as i32`` snap, ``(min3 + 0xF) >> 4`` AABB
rounding, and the ``+1`` bias that turns the inside test into a sign-OR
(rasterizer.rs:1630-1634, 1684).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class TriSetup(NamedTuple):
    """Edge equations and interpolation planes for T triangles.

    Edge i of the reference (e0: v0->v1, e1: v1->v2, e2: v2->v0) evaluates at
    pixel (x, y) as ``A[i]*(x<<4) + B[i]*(y<<4) + C[i]`` in int32; inside =
    sign-OR of all three >= 0. Barycentric b_i = f32(e_i - bias_i) * inv_a2
    — the de-bias happens in INTEGERS so the product is the only f32
    rounding, exactly like the reference's
    ``(e0x - e0add - 1) as f32 * inv_tri_a2`` (rasterizer.rs:1695-1697).
    Vertex weights (v0, v1, v2) <- (b1, b2, b0).
    """

    A: jnp.ndarray        # i32 [T, 3] x-gradients (dy01, dy12, dy20)
    B: jnp.ndarray        # i32 [T, 3] y-gradients (dx10, dx21, dx02)
    C: jnp.ndarray        # i32 [T, 3] constants, fill bias + sign-OR bias folded in
    bias: jnp.ndarray     # f32 [T, 3] integer de-bias (e_add + 1) ∈ {1, 2},
                          #            f32-encoded for channel packing; convert
                          #            to i32 and subtract from e BEFORE the
                          #            single f32 rounding
    inv_a2: jnp.ndarray   # f32 [T]    reciprocal of 2*area
    z0: jnp.ndarray       # f32 [T]    z at v0
    z10: jnp.ndarray      # f32 [T]    z(v1) - z(v0)
    z20: jnp.ndarray      # f32 [T]    z(v2) - z(v0)
    min_x: jnp.ndarray    # i32 [T] pixel AABB, [min, max) convention,
    min_y: jnp.ndarray    # i32 [T] clipped to the framebuffer
    max_x: jnp.ndarray    # i32 [T]
    max_y: jnp.ndarray    # i32 [T]
    valid: jnp.ndarray    # bool [T] front-facing and non-empty AABB


class TriSetupP(NamedTuple):
    """Planar (structure-of-1-D-arrays) triangle setup — the queue-path form.

    Same quantities as TriSetup but every field is a contiguous [T] vector
    (no [T, 3]-shaped fields). A2/B2/C2 are omitted — the kernel
    derives e2 from the integer identity e0 + e1 + e2 = S = C0 + C1 + C2
    (x/y gradients of the three edges sum to zero).
    """

    A0: jnp.ndarray       # i32 [T] edge-0 x-gradient (dy01)
    A1: jnp.ndarray       # i32 [T] edge-1 x-gradient (dy12)
    B0: jnp.ndarray       # i32 [T] edge-0 y-gradient (dx10)
    B1: jnp.ndarray       # i32 [T] edge-1 y-gradient (dx21)
    C0: jnp.ndarray       # i32 [T] edge-0 constant (biases folded)
    C1: jnp.ndarray       # i32 [T]
    C2: jnp.ndarray       # i32 [T] (kept for S and the oracle converter)
    A2: jnp.ndarray       # i32 [T] edge-2 x-gradient (dy20)
    B2: jnp.ndarray       # i32 [T] edge-2 y-gradient (dx02)
    bias0: jnp.ndarray    # f32 [T] integer de-bias (e_add + 1), f32-encoded
    bias1: jnp.ndarray    # f32 [T]
    bias2: jnp.ndarray    # f32 [T]
    inv_a2: jnp.ndarray   # f32 [T]
    z0: jnp.ndarray       # f32 [T]
    z10: jnp.ndarray      # f32 [T]
    z20: jnp.ndarray      # f32 [T]
    min_x: jnp.ndarray    # i32 [T] pixel AABB, [min, max), clipped
    min_y: jnp.ndarray    # i32 [T]
    max_x: jnp.ndarray    # i32 [T]
    max_y: jnp.ndarray    # i32 [T]
    valid: jnp.ndarray    # bool [T]

    def to_trisetup(self) -> "TriSetup":
        """Stacked [T, 3] view for the XLA oracle / bins kernel."""
        return TriSetup(
            A=jnp.stack([self.A0, self.A1, self.A2], axis=1),
            B=jnp.stack([self.B0, self.B1, self.B2], axis=1),
            C=jnp.stack([self.C0, self.C1, self.C2], axis=1),
            bias=jnp.stack([self.bias0, self.bias1, self.bias2], axis=1),
            inv_a2=self.inv_a2, z0=self.z0, z10=self.z10, z20=self.z20,
            min_x=self.min_x, min_y=self.min_y,
            max_x=self.max_x, max_y=self.max_y, valid=self.valid,
        )


def setup_triangles_planar(xs, ys, zs, w: int, h: int,
                           y_shift=0) -> TriSetupP:
    """Corner-major planar form: xs/ys/zs f32 [3, T] viewport coordinates.

    Identical arithmetic to setup_triangles_v per element (28.4 snap, fill
    bias, sign-OR constants, AABB rounding — rasterizer.rs:1545-1634), but
    on [T] lane-major vectors with no [T, k] intermediates anywhere.

    `y_shift` (pixel rows, int) translates the frame AFTER the global
    28.4 snap — the band-sharded renderer's translation trick. Subtracting
    the shift from the FLOAT coordinate before snapping is NOT equivalent:
    truncation is toward zero (Rust `as i32`), so a coordinate that the
    translation moves across zero (e.g. global y 31.97 with a 32-row
    shift) would snap to 0 locally but to -1 globally — a one-pixel
    coverage flip at band boundaries. Snapping globally and translating
    the integer keeps band rasterization bit-identical to the full frame.
    """
    xi = (xs * 16.0).astype(jnp.int32)
    yi = (ys * 16.0).astype(jnp.int32) - (jnp.int32(y_shift) << 4)
    x0, x1, x2 = xi[0], xi[1], xi[2]
    y0, y1, y2 = yi[0], yi[1], yi[2]

    dx10, dy01 = x1 - x0, y0 - y1
    dx21, dy12 = x2 - x1, y1 - y2
    dx02, dy20 = x0 - x2, y2 - y0

    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    front = area2 > 0
    inv_a2 = jnp.where(front, 1.0 / jnp.maximum(area2, 1).astype(jnp.float32),
                       0.0)

    def fill_bias(dy, dx):
        return jnp.where((dy > 0) | ((dy == 0) & (dx > 0)), 1, 0).astype(
            jnp.int32)

    e0a = fill_bias(dy01, dx10)
    e1a = fill_bias(dy12, dx21)
    e2a = fill_bias(dy20, dx02)

    C0 = x0 * y1 - y0 * x1 + e0a + 1
    C1 = x1 * y2 - y1 * x2 + e1a + 1
    C2 = x2 * y0 - y2 * x0 + e2a + 1

    def min3(a, b, c):
        return jnp.minimum(a, jnp.minimum(b, c))

    def max3(a, b, c):
        return jnp.maximum(a, jnp.maximum(b, c))

    min_x = jnp.maximum((min3(x0, x1, x2) + 0xF) >> 4, 0)
    min_y = jnp.maximum((min3(y0, y1, y2) + 0xF) >> 4, 0)
    max_x = jnp.minimum((max3(x0, x1, x2) + 0xF) >> 4, w)
    max_y = jnp.minimum((max3(y0, y1, y2) + 0xF) >> 4, h)

    valid = front & (max_x > min_x) & (max_y > min_y)
    z0 = zs[0]

    return TriSetupP(
        A0=dy01, A1=dy12, B0=dx10, B1=dx21, C0=C0, C1=C1, C2=C2,
        A2=dy20, B2=dx02,
        bias0=(e0a + 1).astype(jnp.float32),
        bias1=(e1a + 1).astype(jnp.float32),
        bias2=(e2a + 1).astype(jnp.float32),
        inv_a2=inv_a2, z0=z0, z10=zs[1] - z0, z20=zs[2] - z0,
        min_x=min_x, min_y=min_y, max_x=max_x, max_y=max_y, valid=valid,
    )


def dilate_setup_planar(s: TriSetupP, d: int, w: int, h: int,
                        area_margin: int = 0) -> TriSetupP:
    """Temporal-coherence superset setup for the amortized moving path.

    Returns a STRUCTURE-build setup whose coverage is a superset of any
    frame whose camera motion (vs this one) displaces vertices by <= d px
    and changes no triangle's signed 2*area by more than `area_margin`:

      * every near-front triangle's pixel AABB expands by `d` px;
      * `valid` widens from strict front-facing to 2*area > -area_margin,
        so silhouette triangles that flip front-facing mid-chunk are
        already binned (a still-backfacing pair self-excludes in the
        kernel: e0+e1+e2 = 2*area < 0 means the sign-OR inside test can
        never pass, and its z lane stays +inf).

    The per-frame kernel always evaluates the TRUE per-frame edge
    functions/AABBs, so rendering through this structure is bit-identical
    to a freshly built queue; `check_queue_valid` certifies the superset
    property at runtime (stale fires loudly if the margins were exceeded).
    Only binning extents and `valid` change — edge equations, z planes
    and the fill convention are untouched.
    """
    # signed 2*area from the stored planar channels: the biased constants
    # satisfy C0+C1+C2 = 2*area + (bias0+bias1+bias2) exactly (integer).
    area2 = (s.C0 + s.C1 + s.C2
             - s.bias0.astype(jnp.int32) - s.bias1.astype(jnp.int32)
             - s.bias2.astype(jnp.int32))
    near_front = area2 > -jnp.int32(area_margin)
    d = jnp.int32(d)
    min_x = jnp.where(near_front, jnp.maximum(s.min_x - d, 0), s.min_x)
    min_y = jnp.where(near_front, jnp.maximum(s.min_y - d, 0), s.min_y)
    max_x = jnp.where(near_front, jnp.minimum(s.max_x + d, w), s.max_x)
    max_y = jnp.where(near_front, jnp.minimum(s.max_y + d, h), s.max_y)
    return s._replace(
        min_x=min_x, min_y=min_y, max_x=max_x, max_y=max_y,
        valid=near_front & (max_x > min_x) & (max_y > min_y),
    )


def setup_triangles(vp: jnp.ndarray, tris: jnp.ndarray, w: int, h: int,
                    y_shift=0) -> TriSetup:
    """vp: f32 [V, 4] viewport-space vertices (x, y, z, 1/w); tris: i32 [T, 3]."""
    return setup_triangles_v(vp[tris[:, 0]], vp[tris[:, 1]], vp[tris[:, 2]],
                             w, h, y_shift)


def setup_triangles_v(v0, v1, v2, w: int, h: int, y_shift=0) -> TriSetup:
    """Corner-array form: v0/v1/v2 f32 [T, 4] — no index gathers.

    De-indexed corner arrays (Scene.c_*) replace per-frame vp[tris[:, i]]
    gathers.

    `y_shift`: integer post-snap frame translation (see
    setup_triangles_planar — float-side translation breaks trunc-to-zero
    parity at band boundaries).
    """
    # 28.4 fixed point, truncating like the reference's `as i32`
    sh = jnp.int32(y_shift) << 4
    x0 = (v0[:, 0] * 16.0).astype(jnp.int32)
    y0 = (v0[:, 1] * 16.0).astype(jnp.int32) - sh
    x1 = (v1[:, 0] * 16.0).astype(jnp.int32)
    y1 = (v1[:, 1] * 16.0).astype(jnp.int32) - sh
    x2 = (v2[:, 0] * 16.0).astype(jnp.int32)
    y2 = (v2[:, 1] * 16.0).astype(jnp.int32) - sh

    dx10, dy01 = x1 - x0, y0 - y1
    dx21, dy12 = x2 - x1, y1 - y2
    dx02, dy20 = x0 - x2, y2 - y0

    # Backface cull + 2*area (rasterizer.rs:1564-1566)
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    front = area2 > 0
    inv_a2 = jnp.where(front, 1.0 / jnp.maximum(area2, 1).astype(jnp.float32), 0.0)

    # Bottom-left fill convention biases (rasterizer.rs:1607-1613)
    def fill_bias(dy, dx):
        return jnp.where((dy > 0) | ((dy == 0) & (dx > 0)), 1, 0).astype(jnp.int32)

    e0a = fill_bias(dy01, dx10)
    e1a = fill_bias(dy12, dx21)
    e2a = fill_bias(dy20, dx02)

    # Constants with the extra +1 enabling the sign-OR inside test
    C0 = x0 * y1 - y0 * x1 + e0a + 1
    C1 = x1 * y2 - y1 * x2 + e1a + 1
    C2 = x2 * y0 - y2 * x0 + e2a + 1

    # Pixel AABB, rounding fixed point up (rasterizer.rs:1589-1592), clipped
    def min3(a, b, c):
        return jnp.minimum(a, jnp.minimum(b, c))

    def max3(a, b, c):
        return jnp.maximum(a, jnp.maximum(b, c))

    min_x = jnp.maximum((min3(x0, x1, x2) + 0xF) >> 4, 0)
    min_y = jnp.maximum((min3(y0, y1, y2) + 0xF) >> 4, 0)
    max_x = jnp.minimum((max3(x0, x1, x2) + 0xF) >> 4, w)
    max_y = jnp.minimum((max3(y0, y1, y2) + 0xF) >> 4, h)

    valid = front & (max_x > min_x) & (max_y > min_y)

    A = jnp.stack([dy01, dy12, dy20], axis=1)
    B = jnp.stack([dx10, dx21, dx02], axis=1)
    C = jnp.stack([C0, C1, C2], axis=1)
    bias = (jnp.stack([e0a, e1a, e2a], axis=1) + 1).astype(jnp.float32)

    return TriSetup(
        A=A, B=B, C=C, bias=bias, inv_a2=inv_a2,
        z0=v0[:, 2], z10=v1[:, 2] - v0[:, 2], z20=v2[:, 2] - v0[:, 2],
        min_x=min_x, min_y=min_y, max_x=max_x, max_y=max_y, valid=valid,
    )
