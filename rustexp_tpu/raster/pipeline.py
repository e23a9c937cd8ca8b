"""The frame pipeline: vertex transform → raster → deferred shade → pack.

Array-native replacement for the reference's ``rast_draw`` orchestrator
(rasterizer.rs:1891-2206). Structural differences, by design:

  * Vertex processing is one batched matmul over all vertices (vs. chunked
    thread-pool scalar loops, rasterizer.rs:1961-1985).
  * Fill mode rasterizes to a (z, tri_id, barycentrics) G-buffer, then a
    single deferred pass shades every visible pixel at once — per-pixel
    shading cost is overdraw-independent, unlike the reference's
    shade-inside-the-depth-test-branch (rasterizer.rs:1722-1744).
  * Per-vertex shading mode shades the vertex batch up front and the
    deferred pass merely interpolates colors — the same two paths as the
    reference's mk_rasterizer! macro instantiations (rasterizer.rs:1772-1773).

All interpolation formulas (z linear in screen space, attributes via
1/w-weighted barycentrics) match rasterizer.rs:1695-1744 exactly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core.colors import pack_abgr32, pack_abgr32_gamma_arith
from ..ops.raster_setup import setup_triangles
from ..ops.raster_xla import GBuffer, raster_gbuffer_xla
from . import shaders as sh

MODE_POINT, MODE_LINE, MODE_FILL = 0, 1, 2
MODE_NAMES = ("Point", "Line", "Fill")

# Vertical-gradient backgrounds (start, end), rasterizer.rs:1287-1294
BACKGROUNDS = (
    ((0.3, 0.3, 0.3), (0.7, 0.7, 0.7)),
    ((1.0, 0.4, 0.0), (0.0, 0.5, 0.5)),
    ((1.0, 0.0, 1.0), (1.0, 0.0, 1.0)),
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
)
NUM_BACKGROUNDS = len(BACKGROUNDS)


class Scene(NamedTuple):
    """Device-resident scene inputs for one frame (a pytree).

    The c_* members are the DE-INDEXED triangle corners ([3T, ...], corner
    j of triangle t at row 3t+j): de-indexing once at scene build turns
    the whole vertex pipeline into gather-free array ops instead of
    per-frame corner gathers (vp[tris[:, j]]).
    """

    positions: jnp.ndarray  # f32 [V, 3] mesh-space
    normals: jnp.ndarray    # f32 [V, 3]
    colors: jnp.ndarray     # f32 [V, 3]
    tris: jnp.ndarray       # i32 [T, 3]
    ndim: jnp.ndarray       # f32 [4, 4] mesh -> unit cube (world)
    it33: jnp.ndarray       # f32 [3, 3] inverse-transpose of ndim's 3x3
    cm: jnp.ndarray         # f32 [5, 6, 64, 64, 3] irradiance cubemap set
    cross: jnp.ndarray      # u32 [ch, cw] unfolded cubemap preview
    c_pos: jnp.ndarray      # f32 [3T, 3] de-indexed corner positions
    c_nrm: jnp.ndarray      # f32 [3T, 3] de-indexed corner normals
    c_col: jnp.ndarray      # f32 [3T, 3] de-indexed corner baked colors
    cp3: jnp.ndarray        # f32 [3, 4, T] corner-major homogeneous positions
    cn3: jnp.ndarray        # f32 [3, 3, T] corner-major normals
    cc3: jnp.ndarray        # f32 [3, 3, T] corner-major baked colors


def make_scene(mesh, cm_set) -> Scene:
    """Build a Scene from assets.mesh.MeshData + assets.cubemap.CubeMapSet.

    The cp3/cn3/cc3 members are CORNER-MAJOR planar layouts (corner j,
    component k, triangle t): every per-triangle quantity downstream is a
    contiguous [T] vector, with no [N, 3]-shaped intermediates.
    """
    ndim = mesh.normalize_dimensions()
    it33 = np.linalg.inv(ndim).T[:3, :3].astype(np.float32)
    tris = np.asarray(mesh.tris)
    flat = tris.reshape(-1)
    pos = np.asarray(mesh.positions)
    nrm = np.asarray(mesh.normals)
    col = np.asarray(mesh.colors)
    posh = np.concatenate([pos, np.ones((pos.shape[0], 1), np.float32)],
                          axis=1)
    return Scene(
        positions=jnp.asarray(mesh.positions),
        normals=jnp.asarray(mesh.normals),
        colors=jnp.asarray(mesh.colors),
        tris=jnp.asarray(mesh.tris),
        ndim=jnp.asarray(ndim),
        it33=jnp.asarray(it33),
        cm=jnp.asarray(cm_set.data),
        cross=jnp.asarray(cm_set.cross),
        c_pos=jnp.asarray(pos[flat]),
        c_nrm=jnp.asarray(nrm[flat]),
        c_col=jnp.asarray(col[flat]),
        cp3=jnp.asarray(posh[tris].transpose(1, 2, 0)),
        cn3=jnp.asarray(nrm[tris].transpose(1, 2, 0)),
        cc3=jnp.asarray(col[tris].transpose(1, 2, 0)),
    )


# ---------------------------------------------------------------------------
# Transform matrices (camera conventions from rasterizer.rs:1236-1259)
# ---------------------------------------------------------------------------


# --- strict-IEEE accumulation (VERDICT r3 next-6) ------------------------
#
# The reference's vertex transform is scalar f32 with per-op rounding and a
# fixed left-to-right accumulation order (nalgebra matmuls,
# rasterizer.rs:1180-1230; the parity oracle's m4_mul/m4_mul_v4 spell the
# order out). XLA preserves that order at the HLO level, but the CPU
# backend's LLVM codegen contracts mul+add pairs into FMAs regardless of
# every available flag (measured in tools/xform_parity.py: eager matches the
# scalar order bit-for-bit, any jitted mul->add chain is 1 ulp off). The
# escape is to launder each product's bits through integer ops keyed by a
# runtime-zero no compiler can constant-fold: the product must then be
# rounded to a real f32 before the add, which is exactly the reference's
# semantics. Costs two integer ops per protected product; elementwise
# [4,T] rows replace [4,4]x[4,T] einsums (the contraction axis is only 4).


from ..ops.ieee import (  # noqa: E402  (placed with its explanatory comment)
    lerp_2mad as _lerp_2mad,
    lerp_3w as _lerp_3w,
    seal as _seal,
    seal_zero as _seal_zero,
)


def _dot3_exact(a, b, z):
    return _seal(a[0] * b[0], z) + _seal(a[1] * b[1], z) + _seal(a[2] * b[2], z)


def _cross3_exact(a, b, z):
    return jnp.stack([
        _seal(a[1] * b[2], z) - _seal(a[2] * b[1], z),
        _seal(a[2] * b[0], z) - _seal(a[0] * b[2], z),
        _seal(a[0] * b[1], z) - _seal(a[1] * b[0], z),
    ])


def _mm4_exact(a, b, z):
    """Fixed-order 4x4 @ 4x4: s = a[i,0]*b[0,j]; s += a[i,1]*b[1,j]; ...
    (the oracle's m4_mul; nalgebra's Mul accumulates in the same order)."""
    s = _seal(a[:, 0:1] * b[0:1, :], z)
    s = s + _seal(a[:, 1:2] * b[1:2, :], z)
    s = s + _seal(a[:, 2:3] * b[2:3, :], z)
    s = s + _seal(a[:, 3:4] * b[3:4, :], z)
    return s


def _mv4_exact(m4, v, z):
    """Fixed-order [4,4] x [4,T] -> [4,T] (the oracle's m4_mul_v4)."""
    s = _seal(m4[:, 0:1] * v[0:1], z)
    s = s + _seal(m4[:, 1:2] * v[1:2], z)
    s = s + _seal(m4[:, 2:3] * v[2:3], z)
    s = s + _seal(m4[:, 3:4] * v[3:4], z)
    return s


def _mv3_exact(m3, v, z):
    """Fixed-order [3,3] x [3,T] -> [3,T] (the oracle's normal transform)."""
    s = _seal(m3[:, 0:1] * v[0:1], z)
    s = s + _seal(m3[:, 1:2] * v[1:2], z)
    s = s + _seal(m3[:, 2:3] * v[2:3], z)
    return s


def look_at(eye, at, up):
    """Reference look_at (rasterizer.rs:1236-1245): division-form normalize,
    left-to-right dots, translation column dot(-eye, axis) — per-op f32."""
    z = _seal_zero(eye)
    za = eye - at
    za = za / jnp.sqrt(_dot3_exact(za, za, z))
    xa = _cross3_exact(up, za, z)
    xa = xa / jnp.sqrt(_dot3_exact(xa, xa, z))
    ya = _cross3_exact(za, xa, z)
    ne = -eye
    return jnp.stack([
        jnp.stack([xa[0], xa[1], xa[2], _dot3_exact(ne, xa, z)]),
        jnp.stack([ya[0], ya[1], ya[2], _dot3_exact(ne, ya, z)]),
        jnp.stack([za[0], za[1], za[2], _dot3_exact(ne, za, z)]),
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=jnp.float32),
    ])


try:
    import ctypes as _ct

    _libm = _ct.CDLL("libm.so.6")
    _libm.tanf.restype = _ct.c_float
    _libm.tanf.argtypes = [_ct.c_float]

    def _tanf(x) -> np.float32:
        return np.float32(_libm.tanf(float(np.float32(x))))
except Exception:  # non-glibc host
    def _tanf(x) -> np.float32:
        return np.tan(np.float32(x))


def perspective(fovy_deg: float, aspect: float, near: float, far: float):
    """Per-op f32 like the reference (rasterizer.rs:1247-1258): tanf of the
    f32 degree product; every divide rounds f32. Static args, so this folds
    to a constant at trace time."""
    f = np.float32
    tan_half = _tanf(f(fovy_deg) * f(0.0174532925) / f(2.0))
    m00 = f(1.0) / (f(aspect) * tan_half)
    m11 = f(1.0) / tan_half
    m22 = -(f(far) + f(near)) / (f(far) - f(near))
    m23 = -(f(2.0) * f(far) * f(near)) / (f(far) - f(near))
    return jnp.array(
        [[m00, 0, 0, 0], [0, m11, 0, 0], [0, 0, m22, m23], [0, 0, -1.0, 0]],
        dtype=jnp.float32,
    )


def viewport_matrix(w: int, h: int):
    wh, hh = w / 2.0, h / 2.0
    return jnp.array(
        [[wh, 0, 0, wh], [0, hh, 0, hh], [0, 0, 1, 0], [0, 0, 0, 1]],
        dtype=jnp.float32,
    )


def inv_world_to_vp(eye, w: int, h: int):
    """Analytic inverse of the world->viewport chain (for ray unprojection).

    Composed from the analytic inverses of look_at (rigid), perspective, and
    viewport — numerically stable in f32, no linear solve.
    """
    zaxis = sh.normalize(eye - jnp.zeros(3, jnp.float32))
    xaxis = sh.normalize(jnp.cross(jnp.array([0.0, 1.0, 0.0]), zaxis))
    yaxis = jnp.cross(zaxis, xaxis)
    R = jnp.stack([xaxis, yaxis, zaxis])  # rows
    inv_look = jnp.concatenate(
        [jnp.concatenate([R.T, eye[:, None]], axis=1),
         jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=jnp.float32)], axis=0)

    aspect = w / h
    tan_half = np.tan(np.float32(45.0) * np.float32(0.0174532925) / 2.0)
    near, far = 0.1, 10.0
    m00 = 1.0 / (aspect * tan_half)
    m11 = 1.0 / tan_half
    m22 = -(far + near) / (far - near)
    m23 = -(2.0 * far * near) / (far - near)
    inv_persp = jnp.array(
        [[1.0 / m00, 0, 0, 0],
         [0, 1.0 / m11, 0, 0],
         [0, 0, 0, -1.0],
         [0, 0, 1.0 / m23, m22 / m23]], dtype=jnp.float32)

    wh, hh = w / 2.0, h / 2.0
    inv_vpm = jnp.array(
        [[1.0 / wh, 0, 0, -1.0], [0, 1.0 / hh, 0, -1.0],
         [0, 0, 1.0, 0], [0, 0, 0, 1.0]], dtype=jnp.float32)
    # HIGHEST: the per-pixel world rays feed parity; a TF32 product would
    # keep only ~3 decimal digits of the chain.
    hi = lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(inv_look, inv_persp, precision=hi), inv_vpm,
                      precision=hi)


def transform_vertices(scene: Scene, eye, w: int, h: int):
    """Mesh space -> (viewport vp with 1/w, world positions, world normals).

    Reference: transform_vertices, rasterizer.rs:1181-1231 — including the
    quirk of applying the viewport matrix *before* the perspective divide.
    """
    z = _seal_zero(eye)
    world_to_vp = _world_to_vp_exact(eye, w, h, z)
    pos_h = jnp.concatenate(
        [scene.positions, jnp.ones((scene.positions.shape[0], 1), jnp.float32)], axis=1
    )
    world_h = _mv4_exact(scene.ndim, pos_h.T, z).T
    world = world_h[:, :3]
    clip = _mv4_exact(world_to_vp, world_h.T, z).T
    inv_w = 1.0 / clip[:, 3]
    vp = jnp.concatenate(
        [_seal(clip[:, :3] * inv_w[:, None], z), inv_w[:, None]], axis=1)
    n_world = _mv3_exact(scene.it33, scene.normals.T, z).T
    return vp, world, n_world


def _world_to_vp_exact(eye, w: int, h: int, z):
    """(viewport @ perspective) @ look_at with the oracle's m4_mul order."""
    return _mm4_exact(
        _mm4_exact(viewport_matrix(w, h),
                   perspective(45.0, w / h, 0.1, 10.0), z),
        look_at(eye, jnp.zeros(3, jnp.float32), jnp.array([0.0, 1.0, 0.0])),
        z)


def transform_corners_planar(scene: Scene, eye, w: int, h: int):
    """Corner-major planar transform: no [N, k] intermediates anywhere.

    Returns (xs, ys, zs, iw, n, world) with xs/ys/zs/iw f32 [3, T] viewport
    coordinates per corner and n/world [3, 3, T] world-space normals /
    positions. Same two-step matmul chain as transform_vertices
    (mesh -> world via ndim, world -> viewport incl. the viewport-before-
    divide quirk, rasterizer.rs:1181-1231) in the reference's exact
    accumulation order on [3, 4, T] operands (see _seal above); vertex
    outputs are bit-identical to the scalar oracle's.
    """
    z = _seal_zero(eye)
    world_to_vp = _world_to_vp_exact(eye, w, h, z)
    world = jnp.stack([_mv4_exact(scene.ndim, scene.cp3[j], z)
                       for j in range(3)])                       # [3, 4, T]
    clip = jnp.stack([_mv4_exact(world_to_vp, world[j], z)
                      for j in range(3)])                        # [3, 4, T]
    iw = 1.0 / clip[:, 3]
    xs = _seal(clip[:, 0] * iw, z)
    ys = _seal(clip[:, 1] * iw, z)
    zs = _seal(clip[:, 2] * iw, z)
    n = jnp.stack([_mv3_exact(scene.it33, scene.cn3[j], z)
                   for j in range(3)])                           # [3, 3, T]
    return xs, ys, zs, iw, n, world[:, :3]


def transform_corners(scene: Scene, eye, w: int, h: int):
    """De-indexed corner transform: (vp_c [3T,4], n_c [3T,3]) — no gathers.

    Identical arithmetic per row as transform_vertices (same fixed-order
    contraction on the same values), so corner results are bit-equal to
    vp[tris[:, j]].
    """
    z = _seal_zero(eye)
    world_to_vp = _world_to_vp_exact(eye, w, h, z)
    pos_h = jnp.concatenate(
        [scene.c_pos, jnp.ones((scene.c_pos.shape[0], 1), jnp.float32)],
        axis=1)
    world_h = _mv4_exact(scene.ndim, pos_h.T, z).T
    clip = _mv4_exact(world_to_vp, world_h.T, z).T
    inv_w = 1.0 / clip[:, 3]
    vp_c = jnp.concatenate(
        [_seal(clip[:, :3] * inv_w[:, None], z), inv_w[:, None]], axis=1)
    n_c = _mv3_exact(scene.it33, scene.c_nrm.T, z).T
    return vp_c, n_c


# ---------------------------------------------------------------------------
# Deferred shading
# ---------------------------------------------------------------------------


def shade_gbuffer(
    gb: GBuffer,
    scene: Scene,
    vp,
    world,
    n_world,
    colors,
    eye,
    tick,
    *,
    per_pixel: bool,
    shader_idx: int,
    bg_fb,
):
    """Interpolate attributes for each visible pixel and shade once.

    Interpolation matches rasterizer.rs:1695-1744: z/w-linear screen-space
    barycentrics with perspective correction through interpolated 1/w.
    """
    h, w = gb.tid.shape
    mask = gb.tid >= 0
    # Flat 1-D indices: one single-index gather per corner.
    t = jnp.maximum(gb.tid, 0).reshape(-1)
    i0, i1, i2 = scene.tris[:, 0][t], scene.tris[:, 1][t], scene.tris[:, 2][t]
    b = gb.b.reshape(-1, 3)
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]

    vp_w = vp[:, 3]
    z = _seal_zero(vp)
    inv_w0, inv_w1, inv_w2 = vp_w[i0], vp_w[i1], vp_w[i2]
    w_raster = 1.0 / _lerp_2mad(inv_w0, inv_w1 - inv_w0, inv_w2 - inv_w0,
                                b2, b0, z)

    def persp_lerp_2mad(a0, a1, a2):
        """v0 + (v1-v0)*b2 + (v2-v0)*b0 form, pre-divided by w (colors).

        Per-op f32 like the reference's per-fragment chain
        (rasterizer.rs:1713-1719 / oracle.cpp c_raster): every product is
        sealed so LLVM cannot contract it into the following add."""
        base = _seal(a0 * inv_w0[..., None], z)
        d10 = _seal(a1 * inv_w1[..., None], z) - base
        d20 = _seal(a2 * inv_w2[..., None], z) - base
        return _lerp_2mad(base, d10, d20, b2[..., None], b0[..., None], z) \
            * w_raster[..., None]

    def persp_lerp_3w(a0, a1, a2):
        """b1/b2/b0-weighted form (world pos / normals,
        rasterizer.rs:1725-1733): (a_j*iw_j)*b — each product rounded, the
        reference's left-to-right order."""
        return _lerp_3w(
            _seal(a0 * inv_w0[..., None], z), _seal(a1 * inv_w1[..., None], z),
            _seal(a2 * inv_w2[..., None], z),
            b1[..., None], b2[..., None], b0[..., None], z,
        ) * w_raster[..., None]

    c = persp_lerp_2mad(colors[i0], colors[i1], colors[i2])
    if per_pixel:
        p = persp_lerp_3w(world[i0], world[i1], world[i2])
        n = persp_lerp_3w(n_world[i0], n_world[i1], n_world[i2])
        out = sh.shader_fn(shader_idx)(p, n, c, eye, tick, scene.cm)
    else:
        out = c  # vertices were pre-shaded

    packed = pack_abgr32_gamma_arith(
        out[..., 0], out[..., 1], out[..., 2]
    ).reshape(h, w)
    return jnp.where(mask, packed, bg_fb)


def queue_attr_channels(scene: Scene, iw, n_c, world_c, colors,
                        per_pixel: bool, ray_world: bool = True):
    """Planar per-triangle attribute channels for the queue kernel.

    Returns (extra, n2, n3): 3*(n2+n3) [T] channels in kernel order —
    (base, d10, d20) for the n2 2-MAD channels (1/w and color), then the
    (q*iw0, q*iw1, q*iw2) triples of the n3 3-weight channels (normals,
    plus world positions when ray_world=False). `colors` is the
    per-unique-vertex shaded colors in V mode, or None in per-pixel mode
    (baked corner colors are static). Every product is sealed so the
    (q*iw - base) chain rounds per-op like the reference's per-triangle
    c10/c20 precompute (oracle.cpp:1242-1243).
    """
    T = scene.tris.shape[0]
    one = jnp.ones((T,), jnp.float32)
    if per_pixel:
        cc = scene.cc3  # static baked corners, zero gathers
        crows = [cc[0], cc[1], cc[2]]         # [3, T] each
    else:
        # per-vertex shaded colors: one [T]-row gather per corner
        crows = [colors[scene.tris[:, j]].T for j in range(3)]

    def base_d(j):
        return [one, crows[j][0], crows[j][1], crows[j][2]]

    zs_ = _seal_zero(iw)
    base = [_seal(q * iw[0], zs_) for q in base_d(0)]
    d10 = [_seal(q * iw[1], zs_) - b for q, b in zip(base_d(1), base)]
    d20 = [_seal(q * iw[2], zs_) - b for q, b in zip(base_d(2), base)]
    extra = base + d10 + d20
    n2, n3 = 4, 0
    if per_pixel:
        if ray_world:
            cat3 = [[n_c[j, k] for k in range(3)] for j in range(3)]
            n3 = 3
        else:
            cat3 = [[world_c[j, k] for k in range(3)]
                    + [n_c[j, k] for k in range(3)] for j in range(3)]
            n3 = 6
        extra = extra + [_seal(q * iw[0], zs_) for q in cat3[0]] \
            + [_seal(q * iw[1], zs_) for q in cat3[1]] \
            + [_seal(q * iw[2], zs_) for q in cat3[2]]
    return extra, n2, n3


def raster_and_shade_queue(
    scene: Scene, queue, colors, eye, tick,
    *, w: int, h: int, per_pixel: bool, shader_idx: int, bg_fb,
    ray_world: bool = True, impl: str = "kernel",
):
    """Flat-queue Fill path (ops/raster_queue.py) — the production path.

    Uses the de-indexed corner arrays (Scene.c_*): triangle setup and
    attribute channels are built without a single per-frame gather (except
    one flat gather of per-vertex-shaded colors in V mode). Per-pixel world
    positions are reconstructed from the interpolated viewport (x, y, z, w)
    by the analytic inverse transform instead of interpolating three extra
    planes (VERDICT r1 #2c); set ray_world=False to interpolate them exactly
    like the reference (parity tests).

    `colors` is the per-unique-vertex shaded colors in V mode, or None in
    per-pixel mode (baked corner colors are static).

    `impl` picks the per-tile raster: "kernel" (the Pallas kernel) or
    "xla" (its plain-XLA twin, raster_attrs_queue_xla) — same bits.

    Returns (fb, stale): `stale` means the cached queue no longer covers
    this frame — rebuild it and re-render.
    """
    from ..ops.raster_queue import raster_attrs_queue, raster_attrs_queue_xla
    from ..ops.raster_setup import setup_triangles_planar

    xs, ys, zs, iw, n_c, world_c = transform_corners_planar(scene, eye, w, h)
    setup = setup_triangles_planar(xs, ys, zs, w, h)
    extra, n2, n3 = queue_attr_channels(scene, iw, n_c, world_c, colors,
                                        per_pixel, ray_world)
    raster = raster_attrs_queue if impl == "kernel" else raster_attrs_queue_xla
    z, mask, lin, stale = raster(queue, setup, tuple(extra), n2, n3, h, w)
    if per_pixel:
        fb = _shade_compacted(queue.rows, scene, z, mask, lin, eye, tick,
                              shader_idx, bg_fb, w, h, ray_world,
                              block_w=int(queue.shade_w))
        return fb, stale

    wr = 1.0 / lin[0]
    c = jnp.stack([q * wr for q in lin[1:4]], axis=-1)
    packed = pack_abgr32_gamma_arith(c[..., 0], c[..., 1], c[..., 2])
    return jnp.where(mask, packed, bg_fb), stale


def _shade_compacted(rows, scene: Scene, z, mask, lin, eye, tick,
                     shader_idx: int, bg_fb, w: int, h: int, ray_world: bool,
                     y0=0, full_h: int | None = None, y_rows=None,
                     block_w: int | None = None):
    """Deferred per-pixel shading over OCCUPIED row-blocks only.

    The per-pixel cubemap lookups are gathers, the largest cost of a P
    frame when run over all w*h pixels. Pixels outside the occupied
    row-block list `rows` (int32 [Rc], entries >= h*ntx are padding; the
    queue passes its build-frozen pair-AABB list) can have no coverage,
    so the planes are compacted to [r_cap, block_w] via a row gather,
    shaded there, and scattered back over the background: the gathers,
    shader math and gamma pack shrink with the occupied share.
    (The reference never shades uncovered pixels either — its shader
    call sits inside the depth-test branch, rasterizer.rs:1722-1744.)

    `y0` / `full_h` support band-sharded frames (parallel/raster_shard.py):
    `h` is then the local band height while the ray-unprojection matrix
    and pixel rows use the GLOBAL frame (y0 = band's first global row,
    full_h = global frame height) — the interpolated planes themselves are
    translation-invariant, only the world-ray reconstruction sees absolute
    coordinates. `y_rows` ([h], overrides y0) maps each LOCAL row to an
    arbitrary global row — the cyclic tile-row interleave's
    non-contiguous bands.

    `block_w` (round 5, default raster_queue.SHADE_W) is the compaction
    granularity and must match what the rows list was built at: entries
    of `rows` index blocks of block_w pixels, id = (y*w + x0) / block_w.
    Narrower blocks skip uncovered x-spans inside occupied rows at the
    cost of more gather/scatter indices (see raster_queue.SHADE_W).
    """
    from ..ops.raster_queue import SHADE_W

    if block_w is None:
        block_w = SHADE_W
    ntx = w // block_w
    padr = rows >= h * ntx
    rows_g = jnp.where(padr, 0, rows)

    def comp(plane):
        return plane.reshape(h * ntx, block_w)[rows_g]      # [Rc, block_w]

    maskc = comp(mask)
    wrc = 1.0 / comp(lin[0])
    cc = jnp.stack([comp(p_) * wrc for p_ in lin[1:4]], axis=-1)
    if ray_world:
        nc = jnp.stack([comp(p_) * wrc for p_ in lin[4:7]], axis=-1)
        zc = comp(z)
        if y_rows is None:
            yc = (rows_g // ntx).astype(jnp.float32)[:, None] + y0
        else:
            yc = jnp.asarray(y_rows, jnp.float32)[rows_g // ntx][:, None]
        xc = ((rows_g % ntx) * block_w).astype(jnp.float32)[:, None] \
            + jnp.arange(block_w, dtype=jnp.float32)[None, :]
        M = inv_world_to_vp(eye, w, h if full_h is None else full_h)
        pc = jnp.stack(
            [wrc * (M[i, 0] * xc + M[i, 1] * yc + M[i, 2] * zc + M[i, 3])
             for i in range(3)], axis=-1)
    else:
        pc = jnp.stack([comp(p_) * wrc for p_ in lin[4:7]], axis=-1)
        nc = jnp.stack([comp(p_) * wrc for p_ in lin[7:10]], axis=-1)
    out = sh.shader_fn(shader_idx)(pc, nc, cc, eye, tick, scene.cm)
    packed = pack_abgr32_gamma_arith(out[..., 0], out[..., 1], out[..., 2])

    bgv = bg_fb.reshape(h * ntx, block_w)
    merged = jnp.where(maskc, packed, bgv[rows_g])
    rows_s = jnp.where(padr, h * ntx, rows)  # pads scatter out of bounds
    return bgv.at[rows_s].set(merged, mode="drop").reshape(h, w)


# ---------------------------------------------------------------------------
# Backgrounds, point/line modes, cubemap-cross overlay
# ---------------------------------------------------------------------------


def background(bg_idx: int, w: int, h: int, y0=0, full_h: int | None = None,
               y_rows=None):
    """Vertical gradient, packed without gamma (rasterizer.rs:1268-1299).

    `y0`/`full_h` evaluate a band of a taller frame's gradient at its
    GLOBAL rows (band-sharded rendering, parallel/raster_shard.py); y0
    may be traced (a mesh axis index). `y_rows` ([h] i32/f32, overrides
    y0) gives each local row an arbitrary global row — the cyclic
    tile-row interleave's non-contiguous bands.
    """
    start, end = BACKGROUNDS[bg_idx]
    ys_g = (y0 + jnp.arange(h, dtype=jnp.float32)) if y_rows is None \
        else jnp.asarray(y_rows, jnp.float32)
    pos = ys_g / float((h if full_h is None else full_h) - 1)
    col = (
        jnp.asarray(start, jnp.float32)[None, :] * (1.0 - pos)[:, None]
        + jnp.asarray(end, jnp.float32)[None, :] * pos[:, None]
    )
    row = pack_abgr32(col[:, 0], col[:, 1], col[:, 2])
    return jnp.broadcast_to(row[:, None], (h, w))


def draw_points(fb, vp, tris, w: int, h: int):
    """Point mode: one white dot per referenced vertex (rasterizer.rs:2013-2028)."""
    idx = tris.reshape(-1)
    x = vp[idx, 0].astype(jnp.int32)
    y = vp[idx, 1].astype(jnp.int32)
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    x = jnp.where(ok, x, 0)
    y = jnp.where(ok, y, 0)
    val = jnp.where(ok, jnp.uint32(0x00FFFFFF), fb[y, x])
    return fb.at[y, x].set(val, mode="drop")


def draw_lines(fb, vp, tris, w: int, h: int, max_steps: int | None = None):
    """Wireframe via vectorized DDA (rasterizer.rs:1301-1329).

    Every edge takes MAX_STEPS parameter samples with unit max-axis spacing,
    masked beyond its true length — the static-shape equivalent of the
    reference's while loop.
    """
    if max_steps is None:
        max_steps = 2 * max(w, h)
    e1 = tris[:, [0, 1]]
    e2 = tris[:, [1, 2]]
    e3 = tris[:, [2, 0]]
    edges = jnp.concatenate([e1, e2, e3], axis=0)  # [E, 2]
    p1 = vp[edges[:, 0], 0:2]
    p2 = vp[edges[:, 1], 0:2]
    # Canonical direction so both windings draw identical pixels
    swap = p2[:, 0] <= p1[:, 0]
    a = jnp.where(swap[:, None], p2, p1)
    b = jnp.where(swap[:, None], p1, p2)
    d = b - a
    s = jnp.maximum(jnp.abs(d[:, 0]), jnp.abs(d[:, 1]))
    step = d / jnp.maximum(s, 1e-30)[:, None]
    m = jnp.arange(max_steps, dtype=jnp.float32)
    pts = a[:, None, :] + step[:, None, :] * m[None, :, None]  # [E, K, 2]
    live = m[None, :] < s[:, None]
    x = pts[..., 0].astype(jnp.int32)
    y = pts[..., 1].astype(jnp.int32)
    ok = live & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    x = jnp.where(ok, x, 0).reshape(-1)
    y = jnp.where(ok, y, 0).reshape(-1)
    val = jnp.where(ok.reshape(-1), jnp.uint32(0x00FFFFFF), fb[y, x])
    return fb.at[y, x].set(val, mode="drop")


def overlay_cross(fb, cross, xorg: int = 10, yorg: int = 10):
    """Blit the unfolded-cubemap preview, skipping alpha-0 pixels
    (rasterizer.rs:529-551). Static placement, clipped to the frame."""
    h, w = fb.shape
    ch, cw = cross.shape
    x1, y1 = min(max(xorg, 0), w), min(max(yorg, 0), h)
    x2, y2 = min(x1 + cw, w), min(y1 + ch, h)
    if x2 <= x1 or y2 <= y1:
        return fb
    sub = cross[0 : y2 - y1, 0 : x2 - x1]
    region = fb[y1:y2, x1:x2]
    merged = jnp.where((sub & jnp.uint32(0xFF000000)) != 0, sub, region)
    return fb.at[y1:y2, x1:x2].set(merged)


# ---------------------------------------------------------------------------
# Frame orchestration
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("w", "h"))
def _queue_stats_jit(scene: Scene, eye, w: int, h: int):
    from ..ops.raster_queue import queue_stats
    from ..ops.raster_setup import setup_triangles_planar

    xs, ys, zs, _, _, _ = transform_corners_planar(scene, eye, w, h)
    setup = setup_triangles_planar(xs, ys, zs, w, h)
    return queue_stats(setup, h, w)


@partial(jax.jit, static_argnames=("w", "h", "s_cap", "m_y", "m_x", "t_cap",
                                   "shade_w"))
def _build_queue_jit(scene: Scene, eye, w: int, h: int, s_cap: int,
                     m_y: int, m_x: int, t_cap: int,
                     shade_w: int | None = None):
    from ..ops.raster_queue import SHADE_W, build_queue
    from ..ops.raster_setup import setup_triangles_planar

    # The build MUST use the same planar setup as the per-frame path:
    # a bitwise-different transform could snap a triangle into a tile the
    # cached structure never enumerated.
    xs, ys, zs, _, _, _ = transform_corners_planar(scene, eye, w, h)
    setup = setup_triangles_planar(xs, ys, zs, w, h)
    return build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                       t_cap=t_cap,
                       shade_w=SHADE_W if shade_w is None else shade_w)


def build_scene_queue(scene: Scene, eye, w: int, h: int,
                      margin: float = 1.3, per_pixel: bool = True,
                      shade_w: int | None = None):
    """Measure + build the flat raster queue for this scene/viewpoint.

    One device round-trip for the static config, then a jitted build. The
    result is a pytree cacheable across frames; render_frame reports `stale`
    (via return_overflow) when the camera has moved beyond it. The
    compacted-shade granularity is chosen per scene from the measured
    occupancy (ops.raster_queue.choose_shade_w) and travels WITH the queue;
    pass per_pixel=False for V-mode configs (the rows list is unused there).
    """
    from ..ops.raster_queue import choose_shade_w, suggest_queue_config

    eye = jnp.asarray(eye, jnp.float32)
    stats = tuple(int(x) for x in
                  jax.device_get(_queue_stats_jit(scene, eye, w, h)))
    if shade_w is None:
        shade_w = choose_shade_w(stats[3], stats[4], per_pixel=per_pixel)
    from ..ops.raster_queue import SHADE_W

    occ = stats[3] if shade_w == SHADE_W else stats[4]
    s_cap, m_y, m_x, t_cap = suggest_queue_config(
        stats[:3] + (occ,), margin=margin)
    return _build_queue_jit(scene, eye, w, h, s_cap, m_y, m_x, t_cap,
                            shade_w)


@partial(
    jax.jit,
    static_argnames=(
        "w", "h", "mode", "per_pixel", "shader_idx", "bg_idx", "show_cm",
        "backend", "return_overflow",
    ),
)
def render_frame(
    scene: Scene,
    eye,
    tick,
    *,
    w: int,
    h: int,
    mode: int = MODE_FILL,
    per_pixel: bool = False,
    shader_idx: int = 5,
    bg_idx: int = 0,
    show_cm: bool | None = None,
    backend: str = "auto",
    raster_queue=None,
    return_overflow: bool = False,
):
    """Render one frame -> uint32 ABGR [h, w], bottom-left origin.

    The array-native rast_draw (rasterizer.rs:1891-2206). ``backend``
    selects the G-buffer producer: "queue" (the flat-queue kernel; pass a
    prebuilt `raster_queue` from build_scene_queue), "queue_xla" (the same
    queue through the kernel's plain-XLA twin), "xla" (the whole-frame
    oracle, O(T·H·W)), or "auto" ("queue" when a queue is given, else
    "xla").

    With ``return_overflow=True`` returns (fb, stale): a traced bool that
    is True when the cached queue no longer covers this frame (or its
    static caps overflowed and triangles were dropped). Interactive callers
    must rebuild the queue when it fires (the reference's dynamic bins are
    exact by construction, rasterizer.rs:2115-2163; static shapes trade
    that for a flag).
    """
    if show_cm is None:
        show_cm = sh.shader_uses_cm(shader_idx)
    if backend == "auto":
        backend = "queue" if raster_queue is not None else "xla"
    if backend in ("queue", "queue_xla") and raster_queue is None:
        raise ValueError(f"backend {backend!r} needs a raster_queue")

    eye = jnp.asarray(eye, jnp.float32)
    tick = jnp.float32(tick)
    vp, world, n_world = transform_vertices(scene, eye, w, h)

    fb = background(bg_idx, w, h)
    overflow = jnp.bool_(False)

    if mode == MODE_POINT:
        fb = draw_points(fb, vp, scene.tris, w, h)
    elif mode == MODE_LINE:
        fb = draw_lines(fb, vp, scene.tris, w, h)
    else:
        colors = scene.colors
        if not per_pixel:
            colors = sh.shader_fn(shader_idx)(
                world, n_world, scene.colors, eye, tick, scene.cm
            )
        if backend in ("queue", "queue_xla"):
            fb, overflow = raster_and_shade_queue(
                scene, raster_queue, None if per_pixel else colors,
                eye, tick, w=w, h=h, per_pixel=per_pixel,
                shader_idx=shader_idx, bg_fb=fb,
                impl="kernel" if backend == "queue" else "xla",
            )
        else:
            setup = setup_triangles(vp, scene.tris, w, h)
            gb = raster_gbuffer_xla(setup, h, w)
            fb = shade_gbuffer(
                gb, scene, vp, world, n_world, colors, eye, tick,
                per_pixel=per_pixel, shader_idx=shader_idx, bg_fb=fb,
            )

    if show_cm:
        fb = overlay_cross(fb, scene.cross)
    if return_overflow:
        return fb, overflow
    return fb
