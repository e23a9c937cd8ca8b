"""Color packing, gamma correction and fast-power LUTs.

Framebuffer pixel format follows the reference convention
(reference: rs-src/nbody.rs:585-617, rs-src/rasterizer.rs:1337-1510):
a 32-bit ABGR value, little-endian byte order R,G,B,A — i.e.
``pixel = R | G<<8 | B<<16 | A<<24`` — row-major with a *bottom-left* origin.

Both lookup tables are regenerated from their closed forms (the reference
embeds them as static arrays; the generator formulas are documented in its
comments at rasterizer.rs:1389-1393 and rasterizer.rs:1060-1070) and verified
element-by-element against the reference tables in tests.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# LUT construction (host-side, numpy, float32 to match the generators)
# ---------------------------------------------------------------------------


def _make_gamma_lut() -> np.ndarray:
    """11-bit gamma-2.2 LUT: round((i/2047)^(1/2.2) * 255) for i in [0, 2048).

    Reference: rasterizer.rs:1389-1393 (generator comment) and the embedded
    GAMMA_11BIT_LUT table at rasterizer.rs:1395-1510.
    """
    i = np.arange(2048, dtype=np.float32)
    v = np.power(i / np.float32(2047.0), np.float32(1.0 / 2.2), dtype=np.float32)
    return np.round(v * np.float32(255.0)).astype(np.uint8)


def _make_pow16_table() -> np.ndarray:
    """256-entry shifted x^16 table: ((600+i)/855)^16 for i in [0, 256).

    Reference: rasterizer.rs:1058-1127 (fast_unit_pow16). The table is shifted
    so more entries land on large values, where 8-bit output still resolves.
    """
    i = np.arange(256, dtype=np.float32) + np.float32(600.0)
    v = i / np.float32(855.0)
    return np.power(v, np.float32(16.0), dtype=np.float32)


GAMMA_11BIT_LUT = _make_gamma_lut()           # uint8 [2048]
POW16_TABLE = _make_pow16_table()             # float32 [256]

# Device-resident copies are created LAZILY: a module-level jnp.asarray
# would initialize the JAX backend at import time, before entry points
# configure JAX (compile cache, platform).
import functools


@functools.lru_cache(maxsize=None)
def _gamma_lut_j():
    return jnp.asarray(GAMMA_11BIT_LUT, dtype=jnp.uint32)


@functools.lru_cache(maxsize=None)
def _pow16_table_j():
    return jnp.asarray(POW16_TABLE, dtype=jnp.float32)


# ---------------------------------------------------------------------------
# Packing (vectorized over arrays of any shape)
# ---------------------------------------------------------------------------


def pack_abgr32(r, g, b):
    """Clamp to [0,1], scale by 255, truncate, pack. No gamma.

    Reference: rgbf_to_abgr32, rasterizer.rs:1337-1345 (`as u32` truncates).
    """
    r8 = (jnp.clip(r, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    g8 = (jnp.clip(g, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    b8 = (jnp.clip(b, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    return r8 | (g8 << 8) | (b8 << 16)


def pack_abgr32_gamma(r, g, b):
    """Gamma-2.2 (11-bit LUT) pack of float RGB into ABGR32.

    Reference: rgbf_to_abgr32_gamma, rasterizer.rs:1347-1387. Faithfully
    reproduces the reference's quirk that the blue channel's negative test
    reads the *red* index (rasterizer.rs:1376).
    """
    ri = (r * 2047.0).astype(jnp.int32)
    gi = (g * 2047.0).astype(jnp.int32)
    bi = (b * 2047.0).astype(jnp.int32)

    def lut(idx):
        return _gamma_lut_j()[jnp.clip(idx, 0, 2047)]

    r8 = jnp.where(ri < 0, jnp.uint32(0), jnp.where(ri > 2047, jnp.uint32(255), lut(ri)))
    g8 = jnp.where(gi < 0, jnp.uint32(0), jnp.where(gi > 2047, jnp.uint32(255), lut(gi)))
    b8 = jnp.where(ri < 0, jnp.uint32(0), jnp.where(bi > 2047, jnp.uint32(255), lut(bi)))
    return r8 | (g8 << 8) | (b8 << 16)


def pack_abgr32_gamma_arith(r, g, b):
    """Gamma-2.2 pack computed arithmetically — no LUT gathers.

    Evaluates the 11-bit LUT's generator formula (rasterizer.rs:1389-1393)
    at the truncated index: round(255 * (trunc(v*2047)/2047)^(1/2.2)).
    Identical quantization semantics to pack_abgr32_gamma, but as
    elementwise transcendentals instead of a per-pixel table gather.
    Keeps the reference's blue-channel quirk (rasterizer.rs:1376).
    """
    ri = (r * 2047.0).astype(jnp.int32)
    gi = (g * 2047.0).astype(jnp.int32)
    bi = (b * 2047.0).astype(jnp.int32)

    def curve(i):
        x = jnp.clip(i, 0, 2047).astype(jnp.float32) * jnp.float32(1.0 / 2047.0)
        v = jnp.round(jnp.power(x, jnp.float32(1.0 / 2.2)) * 255.0)
        return v.astype(jnp.uint32)

    r8 = jnp.where(ri < 0, jnp.uint32(0),
                   jnp.where(ri > 2047, jnp.uint32(255), curve(ri)))
    g8 = jnp.where(gi < 0, jnp.uint32(0),
                   jnp.where(gi > 2047, jnp.uint32(255), curve(gi)))
    b8 = jnp.where(ri < 0, jnp.uint32(0),
                   jnp.where(bi > 2047, jnp.uint32(255), curve(bi)))
    return r8 | (g8 << 8) | (b8 << 16)


def fast_unit_pow16_arith(v):
    """fast_unit_pow16's LUT semantics via arithmetic (no gather).

    Recomputes ((600 + idx) / 855)^16 at idx = trunc(v*855 - 600) by four
    squarings — the same values the reference's table holds
    (rasterizer.rs:1060-1070) without the 256-entry lookup.
    """
    idx = (v * 855.0 - 600.0).astype(jnp.int32)
    x = (jnp.clip(idx, 0, 255).astype(jnp.float32) + 600.0) * jnp.float32(1.0 / 855.0)
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    val = x8 * x8
    return jnp.where(idx < 0, 0.0, jnp.where(idx > 255, 1.0, val))


def pack_abgr32_gamma_np(rgb: np.ndarray) -> np.ndarray:
    """Host-side numpy twin of pack_abgr32_gamma for asset preprocessing.

    rgb: float32 [..., 3] -> uint32 [...] ABGR (alpha 0). Same 11-bit LUT and
    blue-channel quirk as the jnp version (rasterizer.rs:1347-1387).
    """
    i = (rgb.astype(np.float32) * np.float32(2047.0)).astype(np.int32)
    ri, gi, bi = i[..., 0], i[..., 1], i[..., 2]

    def lut(idx):
        return GAMMA_11BIT_LUT[np.clip(idx, 0, 2047)].astype(np.uint32)

    r8 = np.where(ri < 0, np.uint32(0), np.where(ri > 2047, np.uint32(255), lut(ri)))
    g8 = np.where(gi < 0, np.uint32(0), np.where(gi > 2047, np.uint32(255), lut(gi)))
    b8 = np.where(ri < 0, np.uint32(0), np.where(bi > 2047, np.uint32(255), lut(bi)))
    return (r8 | (g8 << 8) | (b8 << 16)).astype(np.uint32)


def unpack_abgr32(c):
    """ABGR32 -> (r, g, b, a) uint32 channels in [0, 255]."""
    c = c.astype(jnp.uint32)
    return c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF, (c >> 24) & 0xFF


def add_abgr32(c1, c2):
    """Per-channel saturating add of two ABGR32 values.

    Reference: add_abgr32, nbody.rs:595-617.
    """
    r1, g1, b1, a1 = unpack_abgr32(c1)
    r2, g2, b2, a2 = unpack_abgr32(c2)
    r = jnp.minimum(jnp.uint32(255), r1 + r2)
    g = jnp.minimum(jnp.uint32(255), g1 + g2)
    b = jnp.minimum(jnp.uint32(255), b1 + b2)
    a = jnp.minimum(jnp.uint32(255), a1 + a2)
    return (a << 24) | (b << 16) | (g << 8) | r


def rgb8_to_abgr32(r: int, g: int, b: int, factor: float) -> int:
    """Host-side: scale an 8-bit RGB triple and pack (reference nbody.rs:585-593)."""
    r_ = min(255, int(np.float32(r) * np.float32(factor)))
    g_ = min(255, int(np.float32(g) * np.float32(factor)))
    b_ = min(255, int(np.float32(b) * np.float32(factor)))
    return r_ | (g_ << 8) | (b_ << 16)


def fast_unit_pow16(v):
    """Fast x^16 for x in [0,1] via the 256-entry shifted LUT.

    Reference: fast_unit_pow16, rasterizer.rs:1058-1127. Index mapping is
    idx = trunc(v*855 - 600); idx<0 -> 0.0, idx>255 -> 1.0.
    """
    idx = (v * 855.0 - 600.0).astype(jnp.int32)
    val = _pow16_table_j()[jnp.clip(idx, 0, 255)]
    return jnp.where(idx < 0, 0.0, jnp.where(idx > 255, 1.0, val))


def abgr32_to_rgb8(fb_u32: np.ndarray) -> np.ndarray:
    """Host-side: unpack a uint32 ABGR framebuffer [h,w] into uint8 RGB [h,w,3]."""
    fb = np.asarray(fb_u32, dtype=np.uint32)
    out = np.empty(fb.shape + (3,), dtype=np.uint8)
    out[..., 0] = fb & 0xFF
    out[..., 1] = (fb >> 8) & 0xFF
    out[..., 2] = (fb >> 16) & 0xFF
    return out
