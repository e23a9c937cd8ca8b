"""Strict-IEEE f32 helpers: per-op rounding under compilers that contract.

The reference's arithmetic is scalar f32 with one rounding per operation
(rustc emits no FMA contraction by default; the parity oracle compiles with
``-ffp-contract=off``). XLA preserves evaluation order at the HLO level, but
the CPU backend's LLVM codegen contracts mul->add chains into FMAs
regardless of every available flag (measured: tools/xform_parity.py — eager
matches the scalar order bit-for-bit, any jitted mul+add chain is 1 ulp
off). The escape is to launder a product's bits through integer ops keyed
by a runtime zero no compiler can constant-fold: the product must then be
rounded to a real f32 before the add — exactly the reference's semantics.

``seal(x, z)`` costs one xor and two (free, layout-preserving) bitcasts per
protected product; ``z`` must come from ``seal_zero`` on any traced value.
The helpers work inside Pallas kernel bodies too: interpret mode executes
them through the same XLA:CPU codegen, and the compiled Triton kernel keeps
the integer round trip, so its products round before the add as well.

Shared by the vertex transform (raster/pipeline.py), the deferred XLA
shading path, and the flat-queue kernel so all backends round attribute
interpolation exactly like the reference's per-fragment scalar code
(rasterizer.rs:1695-1744).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_STRICT: bool | None = None


def strict_default() -> bool:
    """Whether per-op f32 sealing is on (core.platform.strict_ieee_default,
    read once per process)."""
    global _STRICT
    if _STRICT is None:
        from ..core.platform import strict_ieee_default

        _STRICT = strict_ieee_default()
    return _STRICT


def seal_zero(v):
    """An int32 0 derived from a traced value — opaque to constant folding.

    Returns None (= every dependent ``seal`` is identity) when the process
    is in relaxed mode (see ``strict_default``)."""
    if not strict_default():
        return None
    return (v.reshape(-1)[0] * 0.0).astype(jnp.int32)


def seal(x, z):
    """Round x to its stored f32 value: blocks FMA contraction of x into a
    following add/sub by routing the bits through integer ops (identity at
    runtime, since z is always 0).

    ``z=None`` disables the seal (returns x): relaxed mode
    (RUSTEXP_STRICT_IEEE=0), where the compiler may contract products into
    FMAs, like building the reference with -ffp-contract=fast.
    """
    if z is None:
        return x
    return lax.bitcast_convert_type(
        lax.bitcast_convert_type(x, jnp.int32) ^ z, jnp.float32)


def lerp_2mad(q0, q10, q20, b2, b0, z):
    """(q0 + q10*b2) + q20*b0 with per-op rounding — the reference's
    2-MAD attribute form (z, 1/w, colors; rasterizer.rs:1656-1663,
    1695-1719; oracle.cpp c_raster/z/w_raster chains)."""
    return q0 + seal(q10 * b2, z) + seal(q20 * b0, z)


def lerp_3w(qb1, qb2, qb0, b1, b2, b0, z):
    """(qb1*b1 + qb2*b2) + qb0*b0 with per-op rounding — the reference's
    three-weight attribute form (world pos, normals;
    rasterizer.rs:1725-1733)."""
    return seal(qb1 * b1, z) + seal(qb2 * b2, z) + seal(qb0 * b0, z)
