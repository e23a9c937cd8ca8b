"""Bit-packed (SWAR) Game of Life — 32 cells per uint32 word.

Same semantics as ops/gol_stencil.py (reference: gol_step,
rs-src/gol.rs:31-170 — 8-neighbor torus sum, rule ``alive_nb == 3 ||
(alive && alive_nb == 2)``, gol.rs:79), but cells are BITS: word
``P[w, c]`` bit ``b`` holds ``cell[32*w + b, c]``, and the whole neighbor
count runs as bitwise full-adder logic (carry-save arithmetic), ~45
bitwise operations per word per generation.

Packing rows (not columns) into bits keeps both neighbor axes cheap:
column neighbors are neighboring words of the same word row, row
neighbors are in-word shifts plus the boundary bit of the word above or
below. The bit-level rule is exact, so every form here is bit-identical
to step_roll (tests/test_gol.py::test_swar_parity).

Two implementations of one generation:

  * ``_gen_bits`` — plain jnp (rolls in a fori_loop). The CPU path, the
    tests' twin, and the plain-XLA form the kernel is timed against: one
    XLA fusion per generation, one launch each.
  * the CUDA kernel (ops/cuda/gol_swar.cu, through jax.ffi) — on a GPU.
    A block keeps its tile of the packed grid plus a halo in shared
    memory for kk generations (``pick_plan``).
    ``multi_step_packed_tiled`` is the jnp twin of that tiling, so the
    plan and halo logic are tested on the CPU.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

BITS = 32

# Shared memory a block may use for its two tile buffers (H100: up to
# 227 KB per block). Keeping well under it leaves room for two resident
# blocks per SM.
SMEM_BYTES = 96 * 1024
NUM_SMS = 132  # H100 SXM
THREADS = 512  # per block (ops/cuda/gol_swar.cu kBlockX * kBlockY)
# Launch overhead in "rounds" (one round = every thread of a block
# updating one word, ~0.1 us with its barrier): a launch costs ~4 us. A
# modelled constant, not a calibrated one; it only trades halo waste
# against launch count.
LAUNCH_ROUNDS = 40


def pack_rows(grid) -> jnp.ndarray:
    """[R, C] {0,1} int grid -> [R//32, C] uint32, bit b = row 32w+b."""
    r, c = grid.shape
    assert r % BITS == 0, f"rows {r} not a multiple of {BITS}"
    g = grid.astype(jnp.uint32).reshape(r // BITS, BITS, c)
    w = jnp.uint32(1) << jnp.arange(BITS, dtype=jnp.uint32)
    return (g * w[None, :, None]).sum(axis=1, dtype=jnp.uint32)


def unpack_rows(packed, dtype=jnp.int32) -> jnp.ndarray:
    """[W, C] uint32 -> [32*W, C] {0,1} of `dtype`."""
    wn, c = packed.shape
    b = (packed[:, None, :] >> jnp.arange(BITS, dtype=jnp.uint32)[None, :, None])
    return (b & jnp.uint32(1)).astype(dtype).reshape(wn * BITS, c)


def _gen_from_neighbors(p, above, below, left, right):
    """One generation of word array `p` given its four neighbor shifts.

    `above`/`below` map a word array to the word row above/below each
    word (torus roll or zero-filled shift); `left`/`right` likewise for
    columns. Carry-save adders: the vertical 3-row sum per cell is 2 bits
    (s1, s0), the horizontal sum of three such 2-bit numbers is the 4-bit
    3x3 box count (b3..b0); the rule in box form (box = neighbors + self)
    is ``box == 3 || (alive && box == 4)`` — identical to the reference's
    ``nb == 3 || (alive && nb == 2)``.
    """
    one = jnp.uint32(1)
    b31 = jnp.uint32(BITS - 1)

    # Row neighbors: bit b of `up` is cell[32w+b-1], i.e. the row above.
    up = (p << one) | (above(p) >> b31)
    down = (p >> one) | (below(p) << b31)

    # Vertical triple up+p+down as 2-bit carry-save (s1, s0)
    s0 = up ^ p ^ down
    s1 = (up & p) | (down & (up ^ p))

    # Column neighbors of the 2-bit sums
    l0, l1 = left(s0), left(s1)
    r0, r1 = right(s0), right(s1)

    # box bit0 + carry into the 2s column
    b0 = l0 ^ s0 ^ r0
    c0 = (l0 & s0) | (r0 & (l0 ^ s0))

    # 2s column: l1 + s1 + r1 + c0 (0..4) -> bits (b1, h0, h1)
    sa = l1 ^ s1
    ca = l1 & s1
    sb = r1 ^ c0
    cb = r1 & c0
    b1 = sa ^ sb
    c2 = sa & sb
    b2 = ca ^ cb ^ c2
    b3 = (ca & cb) | (c2 & (ca ^ cb))

    # box == 3: b1 & b0, none above; box == 4: only b2
    n23 = ~(b2 | b3)
    eq3 = b0 & b1 & n23
    eq4 = b2 & ~(b0 | b1 | b3)
    return eq3 | (p & eq4)


def _gen_bits(p):
    """One generation on the packed torus (plain jnp)."""
    return _gen_from_neighbors(
        p,
        above=lambda x: jnp.roll(x, 1, 0), below=lambda x: jnp.roll(x, -1, 0),
        left=lambda x: jnp.roll(x, 1, 1), right=lambda x: jnp.roll(x, -1, 1))


def _shift(x, n: int, axis: int):
    """Zero-filled shift: out[i] = x[i - n] along `axis` (0 where out of
    range) — the kernel's tile-edge rule."""
    pad = [(0, 0), (0, 0)]
    if n > 0:
        pad[axis] = (n, 0)
        x = jnp.pad(x, pad)
        return lax.slice_in_dim(x, 0, x.shape[axis] - n, axis=axis)
    pad[axis] = (0, -n)
    x = jnp.pad(x, pad)
    return lax.slice_in_dim(x, -n, x.shape[axis], axis=axis)


def _gen_bits_open(p):
    """One generation of a tile whose outside reads as dead cells."""
    return _gen_from_neighbors(
        p,
        above=lambda x: _shift(x, 1, 0), below=lambda x: _shift(x, -1, 0),
        left=lambda x: _shift(x, 1, 1), right=lambda x: _shift(x, -1, 1))


@partial(jax.jit, static_argnames=("k",))
def multi_step_packed_xla(packed, k: int):
    """k generations on a packed [W, C] grid, one XLA fusion each."""
    return lax.fori_loop(0, k, lambda _, p: _gen_bits(p), packed)


class Plan(NamedTuple):
    """Kernel tiling for a packed [wn, cn] grid: blocks of bw word rows x
    cw columns, each loading a halo of hw = ceil(kk/32) word rows and
    hc = kk columns (torus-wrapped from the grid), run kk generations per
    launch; what leaks in from the halo's open edge travels one cell per
    generation and never reaches the interior."""

    bw: int
    cw: int
    kk: int

    @property
    def hw(self) -> int:
        return -(-self.kk // BITS)

    @property
    def hc(self) -> int:
        return self.kk


def _tile_bytes(th: int, tw: int) -> int:
    return 2 * th * tw * 4  # two uint32 buffers (read / write generation)


def pick_plan(wn: int, cn: int, k: int,
              smem_bytes: int | None = None) -> Plan:
    """The cheapest kernel tiling for k generations of a packed grid.

    Cost per generation, in rounds of the busiest SM (one round = every
    thread of a block updating one word):
      ceil(blocks / NUM_SMS) * ceil(tile_words / THREADS) + LAUNCH_ROUNDS / kk
    over kk in {8, 16, 32, 64} (capped at k), bw | wn and cw | cn with cw
    a multiple of 32 (full warps), both buffers within `smem_bytes`.
    """
    budget = SMEM_BYTES if smem_bytes is None else smem_bytes
    best = None  # (cost, plan)
    kks = sorted({min(kk, max(int(k), 1)) for kk in (8, 16, 32, 64)})
    cws = [c for c in range(BITS, cn + 1, BITS) if cn % c == 0]
    bws = [b for b in range(1, wn + 1) if wn % b == 0]
    for kk in kks:
        hw = -(-kk // BITS)
        for cw in cws:
            for bw in bws:
                th, tw = bw + 2 * hw, cw + 2 * kk
                if _tile_bytes(th, tw) > budget:
                    continue
                blocks = (wn // bw) * (cn // cw)
                waves = -(-blocks // NUM_SMS)
                cost = waves * -(-th * tw // THREADS) + LAUNCH_ROUNDS / kk
                if best is None or cost < best[0]:
                    best = (cost, Plan(bw, cw, kk))
    if best is None:
        raise ValueError(f"no kernel plan fits a packed {wn}x{cn} grid")
    return best[1]


def _launches(k: int, kk: int) -> list[int]:
    """Generations per launch: full kk launches, then the remainder."""
    full, rem = divmod(int(k), kk)
    return [kk] * full + ([rem] if rem else [])


def multi_step_packed_tiled(packed, k: int, plan: Plan):
    """jnp twin of the CUDA kernel's tiling: the same halo loads, tile
    edges that read as dead cells, and per-launch generation counts.
    Bit-identical to multi_step_packed_xla for every valid plan."""
    wn, cn = packed.shape
    hw, hc = plan.hw, plan.hc
    nby, nbx = wn // plan.bw, cn // plan.cw
    rows = (jnp.arange(nby)[:, None] * plan.bw - hw
            + jnp.arange(plan.bw + 2 * hw)[None, :]) % wn
    cols = (jnp.arange(nbx)[:, None] * plan.cw - hc
            + jnp.arange(plan.cw + 2 * hc)[None, :]) % cn
    for g in _launches(k, plan.kk):
        tiles = packed[rows[:, None, :, None], cols[None, :, None, :]]
        tiles = jax.vmap(jax.vmap(
            lambda t: lax.fori_loop(0, g, lambda _, x: _gen_bits_open(x), t)
        ))(tiles)                                   # [nby, nbx, th, tw]
        inner = tiles[:, :, hw:hw + plan.bw, hc:hc + plan.cw]
        packed = inner.transpose(0, 2, 1, 3).reshape(wn, cn)
    return packed


@partial(jax.jit, static_argnames=("k", "platform"))
def multi_step_packed(packed, k: int, platform: str | None = None):
    """k generations on a packed [W, C] uint32 grid (k static).

    On a GPU the CUDA kernel runs the plan pick_plan chooses; on the CPU
    the plain jnp form runs. `platform` defaults to the default backend;
    mesh code passes its devices' platform."""
    from ..core.platform import kernel_mode

    k = int(k)
    if k == 0:
        return packed
    if kernel_mode(platform) == "interpret":
        return multi_step_packed_xla(packed, k)
    from . import cuda_ffi

    wn, cn = packed.shape
    return cuda_ffi.gol_swar(packed, k, pick_plan(wn, cn, k))


@partial(jax.jit, static_argnames=("k", "platform"))
def multi_step_swar(grid, k: int, platform: str | None = None):
    """Drop-in multi_step: [R, C] cell grid -> k generations -> same shape.

    Packs rows to bits, steps, unpacks. Pack/unpack is two cheap vector
    passes per call (not per generation). Rows must be a multiple of 32.
    """
    r, c = grid.shape
    if r % BITS:
        raise ValueError(
            f"{r}x{c} grid not supported by the SWAR kernel (rows % {BITS} "
            "!= 0); use gol_stencil.multi_step")
    out = multi_step_packed(pack_rows(grid), k, platform=platform)
    return unpack_rows(out, dtype=grid.dtype)
