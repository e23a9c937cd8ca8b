"""The 16-shader library, vectorized over fragment batches.

Reference: rasterizer.rs:816-1164. Each shader maps
``(world_pos, world_normal, baked_color, eye, tick, cm) -> linear RGB`` where
all tensor args carry arbitrary leading batch dims (a whole frame of
fragments at once — the reference calls these once per fragment; here one
call shades every pixel as pure VPU work).

``cm`` is a cubemap set as a device array ``[5, 6, 64, 64, 3]`` indexed by
convolution power {cos^0,1,8,64,512} (see assets/cubemap.py); lookups are
major-axis point samples (rasterizer.rs:680-713) expressed as gathers.

Fidelity notes kept from the reference: most shaders square the baked
AO/radiosity color before use (e.g. rasterizer.rs:838), specular lobes are
energy-normalized by (power+2)/2 (rasterizer.rs:872-875), and
Plastic2xDirLight's pow16 uses the shifted 256-entry LUT
(rasterizer.rs:1058-1127, reproduced in core/colors.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.colors import fast_unit_pow16_arith as fast_unit_pow16
from ..ops.ieee import seal as _seal, seal_zero as _seal_zero

# Power-index map into the [5, ...] cubemap array
COS_0, COS_1, COS_8, COS_64, COS_512 = range(5)
CM_FACE_WDH = 64

# Strict-IEEE note (ops/ieee.py): every product feeding an add/sub below is
# sealed so LLVM cannot contract it into an FMA — the reference's shader
# chains are scalar f32 with one rounding per op (rasterizer.rs:816-1164;
# the parity oracle spells out each op order). Lone products and divisions
# round on their own and need no seal.


def _dot(a, b):
    """x*x + y*y + z*z, left-to-right per-op f32 (oracle dot)."""
    z = _seal_zero(a)
    return (_seal(a[..., 0:1] * b[..., 0:1], z)
            + _seal(a[..., 1:2] * b[..., 1:2], z)) \
        + _seal(a[..., 2:3] * b[..., 2:3], z)


def normalize(v):
    """nalgebra normalize: v / sqrt(dot) — DIVISION form (oracle.cpp:57-60)."""
    return v / jnp.sqrt(_dot(v, v))


def fast_normalize(v):
    """Reciprocal-MULTIPLY normalize (rasterizer.rs:55-59): v * (1/sqrt)."""
    return v * (1.0 / jnp.sqrt(_dot(v, v)))


def reflect(i, n):
    """GLSL-style reflection (rasterizer.rs:61-63)."""
    return i - _seal(n * (_dot(n, i) * 2.0), _seal_zero(i))


def normalize_phong_lobe(power: float) -> float:
    return (power + 2.0) * 0.5


def cm_texel_from_dir(d):
    """Direction [..., 3] -> (face, ty, tx) int32 major-axis texel coords.

    Reference: cm_texel_from_dir, rasterizer.rs:680-713. Scale-invariant, so
    callers never need to normalize first.
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    x_major = (ax > ay) & (ax > az)
    y_major = (ay > ax) & (ay > az)

    face = jnp.where(
        x_major,
        jnp.where(dx > 0, 0, 1),
        jnp.where(y_major, jnp.where(dy > 0, 2, 3), jnp.where(dz > 0, 4, 5)),
    ).astype(jnp.int32)
    major = jnp.where(x_major, ax, jnp.where(y_major, ay, az))
    inv = 1.0 / jnp.maximum(major, 1e-30)
    # Seal the u/v products: LLVM would contract them into the +1.0 below
    # (fma), while the reference rounds u = dir.c * inv first
    # (rasterizer.rs:685-713 / oracle.cpp:903-926).
    z = _seal_zero(d)
    u = _seal(jnp.where(x_major, dz, dx) * inv, z)
    v = _seal(jnp.where(x_major, dy, jnp.where(y_major, dz, dy)) * inv, z)

    u = (u + 1.0) * 0.5
    v = (v + 1.0) * 0.5
    tx = jnp.clip((u * CM_FACE_WDH).astype(jnp.int32), 0, CM_FACE_WDH - 1)
    ty = jnp.clip((v * CM_FACE_WDH).astype(jnp.int32), 0, CM_FACE_WDH - 1)
    return face, ty, tx


def lookup_texel_cm(cm, power: int, texel):
    """Single flat-index gather into the [E, 3] table of one convolution
    power; the batch shape is restored afterwards."""
    face, ty, tx = texel
    flat = ((face * CM_FACE_WDH + ty) * CM_FACE_WDH + tx).reshape(-1)
    table = cm[power].reshape(-1, 3)
    return table[flat].reshape(face.shape + (3,))


def lookup_dir_cm(cm, power: int, d):
    return lookup_texel_cm(cm, power, cm_texel_from_dir(d))


def lookup_texel_powers(cm, powers: tuple, texel):
    """Fetch several convolution powers at one texel with a SINGLE gather.

    Packing the power tables channel-wise turns k lookups into one
    gather of k*3-wide rows."""
    face, ty, tx = texel
    flat = ((face * CM_FACE_WDH + ty) * CM_FACE_WDH + tx).reshape(-1)
    tab = jnp.concatenate([cm[p].reshape(-1, 3) for p in powers], axis=1)
    vals = tab[flat].reshape(
        face.shape + (len(powers), 3))
    return tuple(vals[..., i, :] for i in range(len(powers)))


def fresnel_conductor(cosi, eta: float, k: float):
    """PBRT 1st-edition conductor Fresnel (rasterizer.rs:1033-1056)."""
    z = _seal_zero(cosi)
    tmp = _seal((eta * eta + k * k) * cosi * cosi, z)
    x = _seal(2.0 * eta * cosi, z)
    r_par2 = (tmp - x + 1.0) / (tmp + x + 1.0)
    tmp_f = eta * eta + k * k
    cc = _seal(cosi * cosi, z)
    r_per2 = (tmp_f - x + cc) / (tmp_f + x + cc)
    return (r_par2 + r_per2) * 0.5


# ---------------------------------------------------------------------------
# Shaders. Signature: (p, n, col, eye, tick, cm) -> rgb, all [..., 3].
# ---------------------------------------------------------------------------


def shader_color(p, n, col, eye, tick, cm):
    return col


def shader_n_to_color(p, n, col, eye, tick, cm):
    return (normalize(n) + 1.0) * 0.5


def shader_headlight(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    l = fast_normalize(eye - p)
    ldotn = jnp.clip(_dot(l, nn), 0.0, 1.0)
    return col * col * ldotn


def shader_dir_light(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    eyev = p - eye
    r = fast_normalize(reflect(eyev, nn))
    l = jnp.array([0.577350269, 0.577350269, 0.577350269], dtype=jnp.float32)

    def one_light(lv):
        ldotn = jnp.clip(_dot(lv, nn), 0.0, 1.0)
        ldotr = fast_unit_pow16(jnp.clip(_dot(lv, r), 0.0, 1.0))
        return _seal(ldotn * 0.25, z) + _seal(ldotr * 0.75, z)

    light = (
        _seal(jnp.array([1.0, 0.5, 0.5]) * one_light(l), z)
        + _seal(jnp.array([0.5, 0.5, 1.0]) * one_light(-l), z)
        + jnp.array([0.05, 0.05, 0.05], dtype=jnp.float32)
    )
    return light * (col * col)


def shader_cm_diffuse(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    return lookup_dir_cm(cm, COS_1, nn) * (col * col)


def shader_cm_refl(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c8, c64 = lookup_texel_powers(cm, (COS_8, COS_64), r_tex)
    return (
        lookup_dir_cm(cm, COS_1, nn)
        + _seal(c8 * normalize_phong_lobe(8.0), z)
        + _seal(c64 * normalize_phong_lobe(64.0), z)
    ) * (col * col)


def shader_cm_coated(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    eyev = p - eye
    r_tex = cm_texel_from_dir(reflect(eyev, nn))
    fres = fresnel_conductor(_dot(-eyev, nn), 1.0, 1.1)
    c8, c512 = lookup_texel_powers(cm, (COS_8, COS_512), r_tex)
    return (
        _seal(lookup_dir_cm(cm, COS_1, nn) * 0.85, z)
        + _seal(c8 * normalize_phong_lobe(8.0) * fres, z)
        + _seal(c512 * normalize_phong_lobe(512.0) * fres * 1.5, z)
    ) * (col * col)


def shader_cm_diff_rim(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    eyev = p - eye
    fres = fresnel_conductor(_dot(-eyev, nn), 1.0, 1.1)
    return (lookup_dir_cm(cm, COS_1, nn)
            + _seal(fres * 0.75, _seal_zero(p))) * col


def shader_cm_glossy(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r = reflect(p - eye, nn)
    return (
        lookup_dir_cm(cm, COS_1, nn)
        + _seal(lookup_dir_cm(cm, COS_8, r) * normalize_phong_lobe(8.0),
                _seal_zero(p))
    ) * (col * col)


def shader_cm_green_highlight(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    r = reflect(p - eye, nn)
    return (
        lookup_dir_cm(cm, COS_1, nn)
        + _seal(lookup_dir_cm(cm, COS_64, r)
                * normalize_phong_lobe(64.0)
                * jnp.array([0.2, 0.8, 0.2], dtype=jnp.float32),
                _seal_zero(p))
    ) * (col * col)


def shader_cm_red_material(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    r = reflect(p - eye, nn)
    return (
        _seal(lookup_dir_cm(cm, COS_1, nn)
              * jnp.array([0.8, 0.2, 0.2], dtype=jnp.float32), z)
        + _seal(lookup_dir_cm(cm, COS_512, r)
                * normalize_phong_lobe(512.0), z)
    ) * (col * col)


def shader_cm_metallic(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c8, c64 = lookup_texel_powers(cm, (COS_8, COS_64), r_tex)
    return (_seal(c8 * normalize_phong_lobe(8.0), z)
            + _seal(c64 * normalize_phong_lobe(64.0), z)) * col


def shader_cm_super_shiny(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c64, c512, c0 = lookup_texel_powers(cm, (COS_64, COS_512, COS_0), r_tex)
    return (_seal(c64 * normalize_phong_lobe(64.0), z)
            + _seal(c512 * normalize_phong_lobe(512.0), z) + c0) * col


def shader_cm_gold(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    l = fast_normalize(eye - p)
    ldotn = jnp.clip(_dot(l, nn), 0.0, 1.0)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    z = _seal_zero(p)
    albedo = jnp.array([1.0, 0.76, 0.33], dtype=jnp.float32)
    c8, c512 = lookup_texel_powers(cm, (COS_8, COS_512), r_tex)
    return (
        _seal(lookup_dir_cm(cm, COS_1, nn) * ldotn, z)
        + _seal(c8 * normalize_phong_lobe(8.0), z)
        + _seal(c512 * normalize_phong_lobe(512.0) * (1.0 - ldotn), z)
    ) * albedo * (col * col)


def shader_cm_blue(p, n, col, eye, tick, cm):
    nn = fast_normalize(n)
    l = fast_normalize(eye - p)
    ldotn = jnp.clip(_dot(l, nn), 0.0, 1.0)
    z = _seal_zero(p)
    r_tex = cm_texel_from_dir(reflect(p - eye, nn))
    c64, c512 = lookup_texel_powers(cm, (COS_64, COS_512), r_tex)
    return (
        _seal(lookup_dir_cm(cm, COS_1, nn)
              * jnp.array([0.2, 0.2, 0.8], dtype=jnp.float32) * ldotn, z)
        + _seal(c64 * normalize_phong_lobe(64.0) * 0.75, z)
        + _seal(c512 * normalize_phong_lobe(512.0) * (1.0 - ldotn), z)
    ) * (col * col)


def shader_cm_blinn_schlick(p, n, col, eye, tick, cm):
    z = _seal_zero(p)
    nn = fast_normalize(n)
    eyev = p - eye
    r = reflect(eyev, nn)
    # Reference quirk: h = (n+r) * (1/|n+r|) — reciprocal-MULTIPLY form,
    # and the Schlick weight uses the UNNORMALIZED eye vector
    # (rasterizer.rs:1023-1025).
    nr = nn + r
    h = nr * (1.0 / jnp.sqrt(_dot(nr, nr)))
    w = 1.0 - jnp.clip(_dot(h, eyev), 0.0, 1.0)
    w = w * w
    return (
        _seal(lookup_dir_cm(cm, COS_1, nn)
              * jnp.array([0.8, 0.65, 1.0], dtype=jnp.float32) * w, z)
        + _seal(lookup_dir_cm(cm, COS_64, h)
                * normalize_phong_lobe(64.0) * (1.25 - w), z)
    ) * (col * col)


# (name, uses_cubemap, fn) — order matches rasterizer.rs:1135-1160.
SHADER_TABLE = (
    ("BakedColor", False, shader_color),
    ("Normals", False, shader_n_to_color),
    ("Headlight", False, shader_headlight),
    ("Plastic2xDirLight", False, shader_dir_light),
    ("CMDiffuse", True, shader_cm_diffuse),
    ("CMRefl", True, shader_cm_refl),
    ("CMCoated", True, shader_cm_coated),
    ("CMDiffRim", True, shader_cm_diff_rim),
    ("CMGlossy", True, shader_cm_glossy),
    ("CMGreenHighlight", True, shader_cm_green_highlight),
    ("CMRedMaterial", True, shader_cm_red_material),
    ("CMMetallic", True, shader_cm_metallic),
    ("CMSuperShiny", True, shader_cm_super_shiny),
    ("CMGold", True, shader_cm_gold),
    ("CMBlue", True, shader_cm_blue),
    ("CMBlinnSchlick", True, shader_cm_blinn_schlick),
)

NUM_SHADERS = len(SHADER_TABLE)


def shader_name(idx: int) -> str:
    return SHADER_TABLE[idx][0]


def shader_uses_cm(idx: int) -> bool:
    return SHADER_TABLE[idx][1]


def shader_fn(idx: int):
    return SHADER_TABLE[idx][2]
