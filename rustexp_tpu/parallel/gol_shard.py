"""Multi-device Game of Life: row-sharded grid + halo exchange.

The reference's multi-threaded path splits interior rows into horizontal
strips with a separate serial border pass (gol.rs:115-167, 42-85). The
mesh equivalent shards the row axis over the devices; each step
exchanges one halo row with each ring neighbor via `lax.ppermute` (the
torus wrap falls out of the ring permutation), then applies the stencil
locally — identical math, no special border pass.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map


def axis_size(mesh: Mesh, axis) -> int:
    """Total devices along a named axis or a tuple of axes (JAX
    collectives accept the tuple as one combined, row-major linearized
    axis)."""
    if isinstance(axis, str):
        return mesh.shape[axis]
    out = 1
    for a in axis:
        out *= mesh.shape[a]
    return out


def make_multi_step(mesh: Mesh, axis="rows", k: int = 1,
                    backend: str = "roll"):
    """Build a jitted k-generation step over a row-sharded [N, N] grid.

    `axis` may be one mesh axis name or a tuple of axes, which the
    collectives treat as one combined axis.

    backend "roll": one-row halo exchange per generation, stencil via
    jnp.roll — the semantics oracle.

    backend "bits": the production SWAR step (ops/gol_bits.py, 32 cells
    per uint32 word; the CUDA kernel on a GPU) on a k-HALO-PADDED local
    block: each shard ppermutes its k edge rows once, runs all k
    generations locally with zero further communication, and slices the
    interior back out. The local step's y-torus wrap is wrong at the
    padded edges, but wrong values travel inward one row per generation
    and k rows of padding absorb exactly k generations — the interior is
    bit-exact (reference analog gol.rs:115-167). Communication cost: one
    2k-row exchange per k generations instead of 2 rows per generation.
    The halo is rounded up to half the bit-word so the padded block's row
    count stays a multiple of 32.
    """

    n_dev = axis_size(mesh, axis)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def one_step(g):
        # halo_lo = last row of previous shard; halo_hi = first row of next
        halo_lo = lax.ppermute(g[-1:, :], axis, fwd)
        halo_hi = lax.ppermute(g[:1, :], axis, bwd)
        p = jnp.concatenate([halo_lo, g, halo_hi], axis=0)  # [r+2, N]
        r = g.shape[0]
        nb = jnp.zeros_like(g)
        for dy in (0, 1, 2):
            rows = p[dy : dy + r, :]
            for dx in (-1, 0, 1):
                if dy == 1 and dx == 0:
                    continue
                nb = nb + jnp.roll(rows, dx, axis=1)
        return ((nb == 3) | ((g == 1) & (nb == 2))).astype(g.dtype)

    def step_k_roll(local):
        return lax.fori_loop(0, k, lambda i, g: one_step(g), local)

    # The local step follows the MESH's platform: a CPU mesh in a GPU
    # process runs the jnp form, a GPU mesh the kernel.
    platform = mesh.devices.flat[0].platform

    def step_k_bits(local):
        from ..ops import gol_bits

        r = local.shape[0]
        # Round the halo up so the padded row count stays a multiple of
        # the 32-bit word; the extra rows just absorb more generations.
        halo = -(-k // (gol_bits.BITS // 2)) * (gol_bits.BITS // 2)
        if r % gol_bits.BITS:
            raise ValueError(f"shard rows {r} not a multiple of {gol_bits.BITS}")
        if halo > r:
            raise ValueError(f"k={k} exceeds shard rows {r}; lower k")
        lo = lax.ppermute(local[-halo:, :], axis, fwd)
        hi = lax.ppermute(local[:halo, :], axis, bwd)
        padded = jnp.concatenate([lo, local, hi], axis=0)  # [r+2h, N]
        out = gol_bits.multi_step_packed(gol_bits.pack_rows(padded), k,
                                         platform=platform)
        full = gol_bits.unpack_rows(out, dtype=local.dtype)
        return lax.dynamic_slice_in_dim(full, halo, r, axis=0)

    bodies = {"roll": step_k_roll, "bits": step_k_bits}
    if backend not in bodies:
        # An unknown name must not silently run the slower oracle.
        raise ValueError(f"backend {backend!r} not one of {sorted(bodies)}")
    body = bodies[backend]
    # check_rep off for the kernel: an FFI call carries no varying-mesh-axes
    # info on its outputs
    step = shard_map(body, mesh=mesh, in_specs=(P(axis, None),),
                     out_specs=P(axis, None),
                     check_rep=backend == "roll")
    return jax.jit(step)


def shard_grid(grid, mesh: Mesh, axis="rows"):
    return jax.device_put(grid, NamedSharding(mesh, P(axis, None)))
