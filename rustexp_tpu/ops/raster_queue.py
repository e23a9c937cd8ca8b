"""Flat-queue tile rasterizer — the production G-buffer producer.

The screen is tiled TILE_H x TILE_W. ``build_queue`` bins every
front-facing triangle into the tiles its pixel AABB overlaps and lays the
(tile, triangle) pairs out as one flat queue: each tile owns a contiguous
segment of slots (``Queue.tiles`` gives its first slot and pair count).
``raster_attrs_queue`` then runs one kernel program per tile — the
reference's tile-exclusive ownership (rasterizer.rs:2074-2198): a tile's
program walks its own segment with z, winning triangle id and the
interpolated attribute planes held in registers, so depth writes need no
atomics and no program waits on another. Every program initializes its
own output tile.

Slot order within a tile is either ascending triangle id (submission
order) or the plane order (one small sort instead of the big pair-key
sort). The depth race is the lexicographic min over (z, triangle id),
which reproduces the reference's first-wins tie rule (strict-less against
ascending submission, rasterizer.rs:1704-1708) whatever order the pairs
come in; the background (triangle id -1 at z = 1.0) wins ties, so a
fragment at exactly z == 1.0 is never drawn (rasterizer.rs:1706).

Two implementations of the per-tile program:

  * the Pallas kernel (``backend="triton"``), compiled on a GPU and run
    in the Pallas interpreter on the CPU;
  * ``raster_attrs_queue_xla`` — the plain-XLA twin: a chunk of a tile's
    pairs is evaluated at once and reduced by lexicographic min, chunks
    combine by the same min, and the winners' attribute planes are
    selected from the chunk's evaluation.

The queue STRUCTURE (which triangle lands in which slot) depends only on
AABB/tile geometry, so callers may cache it across frames;
``check_queue_valid`` reports whether a new frame's setup still fits the
cached structure (camera moved too far -> rebuild).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .ieee import lerp_2mad, lerp_3w, strict_default
from .raster_setup import TriSetup

# Tile shape: 8x128 px with 8 warps per tile program, from the H100 A/B of
# 16x128, 16x64, 8x128 and 8x64 (PERF.md): 256 programs at 512^2 against
# 128 for 16x128; 8x64 was faster still on fixed-eye frames but made the
# per-frame queue rebuild of the moving suite slower by up to 42%.
TILE_H = 8
TILE_W = 128
CHUNK = 128  # queue slots per chunk: the unit of segment alignment and of
# the XLA twin's vectorized batch
ROW_MARGIN = 2  # rows of camera-drift headroom baked into Queue.rows/ylim.
# Margin rows are shaded every frame (up to 2*margin extra rows per tile);
# 2 still absorbs 2 px of drift before a rebuild — interactive orbits move
# <1 px/frame in y.
SHADE_W = 64  # FINE compacted-shade block width (px). The deferred shade
# pass gathers only OCCUPIED blocks; narrower blocks skip uncovered
# x-spans inside occupied rows (silhouette scenes) at the cost of 2x the
# gather/scatter indices. Must divide TILE_W. NOT unconditional: scenes
# whose geometry spans full tile widths gain nothing, and per-frame-rebuild
# paths pay extra build work for it — callers pick per scene via
# choose_shade_w.

# int channels per triangle row:
#   A0 A1 B0 B1 C0 C1 S min_x min_y max_x max_y
_I_CH = 11
_F_CH = 7  # bias0 bias1 bias2 z0 z10 z20 inv_a2  (+ 3*(n2+n3) attr channels)


@jax.tree_util.register_static
class StaticInt(int):
    """An int pytree node with NO leaves — the value is aux (structure) data.

    Queue.shade_w must survive jit as a PYTHON int (it is a reshape
    dimension in the shade paths); a plain int field would flatten to a
    traced leaf. As structure data, two queues built at different shade
    granularities are different pytree structures — a queue can never be
    rendered at the wrong granularity, it recompiles instead.
    """


def choose_shade_w(occ_fine: int, occ_tile: int, *,
                   fine_w: int = SHADE_W, tile_w: int = TILE_W,
                   rebuild_per_frame: bool = False,
                   per_pixel: bool = True) -> int:
    """Pick the compacted-shade block granularity for one scene config.

    `occ_fine` / `occ_tile` are the occupied-block counts queue_stats
    reports at fine_w / tile_w granularity. Finer blocks shade fewer
    pixels but double the gather/scatter index count and (when the queue
    is rebuilt per frame) add four [T, nT] extent reductions + a 2x
    argsort to every build. The thresholds come from a per-scene A/B
    on the accelerator this system was first tuned on and are not yet
    re-derived on the GPU (ROADMAP); they read the scene's own
    occupancy, not the hardware:

      * cached queue (fixed eye): >13.5% estimated savings -> fine.
      * per-frame rebuild (moving): >14.5% -> fine (the finer build work
        is paid every frame).
      * per-vertex shading (V modes): the rows list is never consumed —
        always tile_w (the fine build work would be pure waste).
    """
    if not per_pixel:
        return tile_w
    px_fine = occ_fine * fine_w
    px_tile = max(occ_tile * tile_w, 1)
    savings = 1.0 - px_fine / px_tile
    return fine_w if savings > (0.145 if rebuild_per_frame else 0.135) \
        else tile_w


class Queue(NamedTuple):
    """Camera-coherent raster work queue (a pytree; cacheable across frames)."""

    ids: jnp.ndarray        # i32 [S, chunk] triangle id per slot, -1 = empty
    tiles: jnp.ndarray      # i32 [nT, 3] per LOCAL tile (first slot, pair
    #                         count, global tile row) — the global row ==
    #                         the local one except for cyclic-interleaved
    #                         band queues (row_stride>1)
    ranges: jnp.ndarray     # i32 [T, 4] binned tile ranges (ty0, ty1, tx0, tx1)
    built_valid: jnp.ndarray  # bool [T] triangle was front-facing at build
    overflow: jnp.ndarray   # bool [] structure truncated (spans/S/rows exceeded)
    rows: jnp.ndarray       # i32 [Rc] occupied flat SHADE-BLOCK ids (one id
    #                         per shade_w-wide pixel span: (y * w + x0) /
    #                         shade_w); h*(w//shade_w) = pad. Deferred shading
    #                         runs on these blocks only — anything not listed
    #                         has no coverage
    ylim: jnp.ndarray       # i32 [T, 2] per-triangle y-extent (with margin)
    #                         the rows list was built from; check_queue_valid
    #                         requires the frame's AABBs to stay inside it
    xlim: jnp.ndarray       # i32 [T, 2] per-triangle x-extent (with margin),
    #                         same contract as ylim: within-tile x drift can
    #                         cover shade blocks the built rows list skips
    #                         (full-range when shade_w == tile_w: tile
    #                         containment already bounds x there)
    shade_w: StaticInt      # STATIC block width the rows list was built at
    #                         (pytree structure data, not a leaf) — the shade
    #                         paths reshape output planes by it


def tile_ranges(setup: TriSetup, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Inclusive tile index ranges covered by each (clipped) pixel AABB."""
    ty0 = setup.min_y // tile_h
    ty1 = (setup.max_y - 1) // tile_h
    tx0 = setup.min_x // tile_w
    tx1 = (setup.max_x - 1) // tile_w
    return ty0, ty1, tx0, tx1


def _plane_run_table(m_y: int, m_x: int):
    """Static run enumeration for the plane-ordered build.

    A run (dy, dx, cls) is the subset of a base-tile group with span class
    `cls` = (sy-1)*m_x + (sx-1) that plane (dy, dx) re-binned to the tile
    shifted by (dy, dx); it exists iff dy < sy and dx < sx. R =
    [m_y(m_y+1)/2]*[m_x(m_x+1)/2] runs per tile.
    """
    runs = [(dy, dx, (sy - 1) * m_x + (sx - 1))
            for dy in range(m_y) for dx in range(m_x)
            for sy in range(dy + 1, m_y + 1) for sx in range(dx + 1, m_x + 1)]
    return runs


def build_queue(
    setup: TriSetup, h: int, w: int, *,
    s_cap: int, m_y: int, m_x: int, t_cap: int | None = None,
    chunk: int = CHUNK, tile_h: int = TILE_H, tile_w: int = TILE_W,
    order: str = "auto", row_stride: int = 1, row_offset=0,
    shade_w: int = SHADE_W,
) -> Queue:
    """Construct the flat queue from a frame's triangle setup.

    `shade_w` (round 5) is the compacted-shade block granularity the
    `rows` list is built at — either the fine SHADE_W or tile_w (which
    skips the x-extent build work entirely). The queue CARRIES it as
    static pytree structure (Queue.shade_w), so the render paths always
    shade at the granularity the rows were built at; pick it per scene
    with choose_shade_w.

    `row_stride` / `row_offset` (round 5) build a CYCLIC-interleaved band:
    this queue covers only the global tile rows g with g % row_stride ==
    row_offset, mapped to local tile row g // row_stride — the sharded
    rasterizer's load-balance interleave (the reference's analog is its
    sort-tiles-by-bin-size schedule, rasterizer.rs:2165-2167). `setup`
    must then be the UNSHIFTED global-frame setup and `h` the GLOBAL
    frame height; edge functions and AABB channels stay global (the
    kernel evaluates at global pixel coordinates via the per-chunk global
    tile row scalar), so no translation trick is needed and band output
    rows are bit-identical to the same rows of a whole-frame render.
    `ranges`/`ylim` stay in GLOBAL tile/pixel coordinates, which makes
    check_queue_valid interleave-agnostic: a triangle staying inside its
    built global tile range covers a subset of the strided rows it was
    binned to.

    Static config (s_cap = chunk rows, m_y/m_x = max tile spans enumerated)
    comes from `suggest_queue_config`. Reference analog: the per-tile Vec push
    binning loop rasterizer.rs:2115-2163, re-shaped as static-shape XLA ops.

    `order` picks the slot order within each tile's segment and the sort
    that produces it ("auto" = plane for dense meshes, tri for tiny or
    huge-span ones):

      * "plane" (round 5): every enumeration plane (dy, dx) maps
        triangle i to tile base_tile(i) + (dy*ntx + dx) — a CONSTANT shift
        of the same base key — so ONE ascending sort of T keys
        (base_tile, span_class, tri) replaces the T*m_y*m_x pair-key sort,
        and each tile's segment is reassembled from <=R contiguous runs of
        the single sorted array: T keys sorted instead of T*m_y*m_x.
        Slots are NOT in ascending triangle order; the kernels' (z, tri)
        depth race reproduces the reference's first-wins tie rule anyway.
      * "tri": ascending triangle id within each tile (the reference's
        submission order), from a full pair-key sort.
      * "direct": small meshes (auto: T <= 64, or T <= 2048 with
        T*s_cap*chunk <= 2^25) — identical layout to "tri" but with counts
        and slot ids read straight off the coverage matrix (cumsum ranks +
        a rank-match contraction): no key construction, no sort, no
        searchsorted, no slot gather.
    """
    nty_g, ntx = h // tile_h, w // tile_w   # GLOBAL tile grid
    if nty_g % row_stride:
        raise ValueError(
            f"{nty_g} tile rows not divisible by row_stride={row_stride}")
    nty = nty_g // row_stride               # LOCAL tile rows this queue owns
    n_tiles = nty * ntx                     # local tiles
    n_tiles_g = nty_g * ntx
    T = setup.valid.shape[0]
    row_offset = jnp.asarray(row_offset, jnp.int32)  # may be an axis index

    ty0, ty1, tx0, tx1 = tile_ranges(setup, tile_h, tile_w)
    span_y = ty1 - ty0 + 1
    span_x = tx1 - tx0 + 1

    if order == "auto":
        # Thresholds from an earlier accelerator's A/Bs of the full moving
        # frame; not yet re-derived on the GPU. Small meshes skip
        # keys/sort/gather entirely — slot ids fall straight out of the
        # coverage matrix — as long as the [T, s_cap, chunk] rank-match
        # stays small. Above that, plane's single T-key sort + run tables
        # replace the pair-key sort unless huge per-triangle spans explode
        # the run table R = O(m_y^2 m_x^2).
        R_est = (m_y * (m_y + 1) // 2) * (m_x * (m_x + 1) // 2)
        if T <= 64 or (T <= 2048 and T * s_cap * chunk <= 2 ** 25):
            order = "direct"
        else:
            order = "plane" if (T >= 2048 and R_est <= 512) else "tri"
    if order == "plane" and n_tiles_g * (m_y * m_x) * (T + 1) >= 2 ** 31:
        order = "tri"  # key space must fit int32; fall back to the big sort

    # Local-tile coverage; tile rows compare at their GLOBAL indices.
    # Used by the rows list below and by the "direct" order's counts/slots.
    ty_ar = jnp.arange(nty, dtype=jnp.int32) * row_stride + row_offset
    tx_ar = jnp.arange(ntx, dtype=jnp.int32)
    cov_y = (ty_ar[None, :] >= ty0[:, None]) & (ty_ar[None, :] <= ty1[:, None])
    cov_x = (tx_ar[None, :] >= tx0[:, None]) & (tx_ar[None, :] <= tx1[:, None])
    cov = (cov_y[:, :, None] & cov_x[:, None, :]
           & setup.valid[:, None, None]).reshape(T, n_tiles)

    if order == "direct":
        # --- tiny-mesh build: no keys, no sort, no gathers ------------------
        # With T <= chunk, a tile's whole segment is its covering triangles
        # in ascending id order — exactly the "tri" layout — and the
        # exclusive rank of each triangle within each tile's segment is a
        # cumsum down the (m-span-clipped, to match the pair enumeration)
        # coverage matrix. Slot ids then come from a [T, S, chunk]
        # rank-match one-hot contraction (f32 at HIGHEST precision is
        # exact: ids < 2^24; a TF32 pass would not be).
        win_y = cov_y & (ty_ar[None, :] - ty0[:, None] < m_y)
        win_x = cov_x & (tx_ar[None, :] - tx0[:, None] < m_x)
        cov_m = (win_y[:, :, None] & win_x[:, None, :]
                 & setup.valid[:, None, None]).reshape(T, n_tiles)
        cov_mi = cov_m.astype(jnp.int32)
        rank = jnp.cumsum(cov_mi, axis=0) - cov_mi     # exclusive [T, nT]
        counts = jnp.sum(cov_mi, axis=0)
    elif order == "plane":
        # --- single-sort plane-shifted build -------------------------------
        # Group keys stay GLOBAL under the interleave (the sort and
        # histogram cover the whole frame); only the run table below picks
        # the local tiles' source groups, so an interleaved plane build
        # sorts once per device but reconstructs only its own rows.
        C = m_y * m_x
        sy = jnp.clip(span_y, 1, m_y)
        sx = jnp.clip(span_x, 1, m_x)
        cls = (sy - 1) * m_x + (sx - 1)
        base = ty0 * ntx + tx0
        group = base * C + cls                       # [T] in [0, n_tiles_g*C)
        tri = jnp.arange(T, dtype=jnp.int32)
        big = jnp.int32(n_tiles_g * C * T)
        skey = jnp.sort(jnp.where(setup.valid, group * T + tri, big))
        stri = skey % T                              # sorted tri ids
        # Group lengths WITHOUT searchsorted: the (base, class) histogram
        # factorizes over y and x, so one [nty_g*m_y, T] @ [T, ntx*m_x]
        # one-hot matmul counts every group exactly (f32 at HIGHEST
        # precision is exact for integer counts < 2^24; TF32 is not).
        uy = ((ty0[:, None] == jnp.arange(nty_g, dtype=jnp.int32)[None, :])
              & setup.valid[:, None])
        usy = sy[:, None] == jnp.arange(1, m_y + 1, dtype=jnp.int32)[None, :]
        ux = tx0[:, None] == jnp.arange(ntx, dtype=jnp.int32)[None, :]
        usx = sx[:, None] == jnp.arange(1, m_x + 1, dtype=jnp.int32)[None, :]
        U = (uy[:, :, None] & usy[:, None, :]).reshape(T, nty_g * m_y)
        V = (ux[:, :, None] & usx[:, None, :]).reshape(T, ntx * m_x)
        cnt_yx = jnp.einsum("ta,tb->ab", U.astype(jnp.float32),
                            V.astype(jnp.float32),
                            precision=lax.Precision.HIGHEST)
        glen = (cnt_yx.reshape(nty_g, m_y, ntx, m_x)
                .transpose(0, 2, 1, 3).reshape(-1).astype(jnp.int32))
        gbounds = jnp.concatenate([
            jnp.zeros((1,), jnp.int32), jnp.cumsum(glen)])  # [n_tiles_g*C+1]

        # Per-tile run tables [n_tiles, R] WITHOUT gathers: for a fixed
        # run (dy, dx, cls) the source group of tile (t_y, t_x) is the
        # group of tile (t_y-dy, t_x-dx) at class cls — a constant 2-D
        # SHIFT of the [nty_g, ntx, C] group-fact image: m_y*m_x pad+slice
        # ops on [nty_g, ntx, ...] blocks instead of two [nT, R] gathers.
        # Pad value 0 reproduces the gather form's src_ok masking exactly
        # (run_len 0, run_start gbounds[0] = 0 at out-of-range sources).
        # Run order is _plane_run_table's (dy, dx, sy, sx) flattening —
        # the slot-order contract the run-membership matvec depends on.
        g3 = glen.reshape(nty_g, ntx, C)
        gb3 = gbounds[:-1].reshape(nty_g, ntx, C)
        off = row_offset  # traced under shard_map; dynamic_slice below

        def _shifted(img, dy, dx, cls_list):
            # img[t_y - dy, t_x - dx, cls_list] over this queue's local
            # tiles (t_y = off + row_stride*j), zeros out of range.
            pad = jnp.pad(img[:, :, jnp.asarray(cls_list)],
                          ((dy, row_stride), (dx, 0), (0, 0)))
            win = jax.lax.dynamic_slice(
                pad, (off, jnp.int32(0), jnp.int32(0)),
                (nty_g, ntx, len(cls_list)))
            return win[::row_stride][:nty]          # [nty, ntx, len(cls)]

        rl_parts, rs_parts = [], []
        for dy in range(m_y):
            for dx in range(m_x):
                cls_list = [(sy - 1) * m_x + (sx - 1)
                            for sy in range(dy + 1, m_y + 1)
                            for sx in range(dx + 1, m_x + 1)]
                rl_parts.append(_shifted(g3, dy, dx, cls_list))
                rs_parts.append(_shifted(gb3, dy, dx, cls_list))
        R = sum(p.shape[-1] for p in rl_parts)
        run_len = jnp.concatenate(rl_parts, axis=-1).reshape(n_tiles, R)
        run_start = jnp.concatenate(rs_parts, axis=-1).reshape(n_tiles, R)
        counts = jnp.sum(run_len, axis=1).astype(jnp.int32)
    else:
        # --- legacy full pair-key sort -------------------------------------
        # Pair enumeration per (triangle, dy, dx); tiles beyond the static
        # m_y/m_x spans are not enumerated (overflow flag below).
        dy = jnp.arange(m_y, dtype=jnp.int32)
        dx = jnp.arange(m_x, dtype=jnp.int32)
        t_ty = ty0[:, None, None] + dy[None, :, None]
        t_tx = tx0[:, None, None] + dx[None, None, :]
        ok = (
            setup.valid[:, None, None]
            & (dy[None, :, None] < span_y[:, None, None])
            & (dx[None, None, :] < span_x[:, None, None])
            # Interleave: only pairs landing on this queue's global rows
            # (t_ty % 1 == 0 always holds, so stride 1 costs nothing)
            & (t_ty % row_stride == row_offset)
        )
        tile_id = (t_ty // row_stride) * ntx + t_tx   # LOCAL tile id

        # Pair keys sorted by (tile, tri): ascending triangle id within a
        # tile (the reference's submission order).
        tri_id = jnp.broadcast_to(
            jnp.arange(T, dtype=jnp.int32)[:, None, None], tile_id.shape)
        big = jnp.int32(n_tiles * T)
        skey = jnp.sort(jnp.where(ok, tile_id * T + tri_id, big).reshape(-1))

        bounds = jnp.searchsorted(
            skey, jnp.arange(n_tiles + 1, dtype=jnp.int32) * T
        ).astype(jnp.int32)
        counts = bounds[1:] - bounds[:-1]  # [nT]

    # Chunk-aligned segment layout: tile t owns chunks [starts, starts +
    # cpt); only tiles with pairs get chunks. Tiles whose segment runs
    # past s_cap are truncated there (overflow below flags the frame).
    cpt = (counts + chunk - 1) // chunk           # chunks per tile
    starts = jnp.cumsum(cpt) - cpt                # first chunk index per tile
    total_chunks = jnp.sum(cpt)

    cs = jnp.arange(s_cap, dtype=jnp.int32)
    lo = starts
    hi = starts + cpt
    in_tile = (cs[None, :] >= lo[:, None]) & (cs[None, :] < hi[:, None])
    tile_of = jnp.argmax(in_tile, axis=0).astype(jnp.int32)
    chunk_live = jnp.any(in_tile, axis=0)
    k_of = cs - starts[tile_of]
    cnt = jnp.clip(counts[tile_of] - k_of * chunk, 0, chunk)
    cnt = jnp.where(chunk_live, cnt, 0)
    # Per-tile segment table. Column 2 is the GLOBAL tile row: the kernel
    # evaluates edge functions at global pixel coordinates while its
    # output tile stays local — what makes cyclic-interleaved band output
    # rows bit-identical to the same rows of a whole-frame render.
    t_count = jnp.clip(jnp.minimum(counts, (s_cap - starts) * chunk), 0)
    gty = (jnp.arange(n_tiles, dtype=jnp.int32) // ntx) * row_stride \
        + row_offset
    tiles = jnp.stack([starts * chunk, t_count, gty], axis=1)  # [nT, 3]

    slot_ok = jnp.arange(chunk, dtype=jnp.int32)[None, :] < cnt[:, None]
    if order == "direct":
        # Slot (s, j) holds the triangle whose within-tile rank equals the
        # slot's global rank — a rank-match one-hot contracted against the
        # triangle ids (counts <= T <= chunk, so k_of is always 0 for live
        # chunks; kept general for uniformity with the other orders).
        cov_sel = jnp.take(cov_m, tile_of, axis=1)       # [T, S]
        rank_sel = jnp.take(rank, tile_of, axis=1)       # [T, S]
        rr = k_of[:, None] * chunk + jnp.arange(
            chunk, dtype=jnp.int32)[None, :]             # [S, chunk]
        match = (cov_sel[:, :, None]
                 & (rank_sel[:, :, None] == rr[None, :, :]))
        ids = jnp.einsum(
            "tsj,t->sj", match.astype(jnp.float32),
            jnp.arange(T, dtype=jnp.float32),
            precision=lax.Precision.HIGHEST).astype(jnp.int32)
        ids = jnp.where(slot_ok, ids, -1)
    elif order == "plane":
        # Slot -> source pair: rank k within the tile's segment falls in
        # run r iff exclusive-cum[r] <= k < inclusive-cum[r]; empty runs
        # admit no rank, so exactly one run matches any k < counts[tile].
        # GATHER-FREE form: the one-hot run membership matrix contracts
        # against b = run_start - exclusive_cum in a batched matvec —
        # exact in f32 at HIGHEST precision (positions < 2^24).
        kk = k_of[:, None] * chunk + jnp.arange(
            chunk, dtype=jnp.int32)[None, :]             # [S, chunk]
        rlen_t = run_len[tile_of]                        # [S, R]
        rinc_t = jnp.cumsum(rlen_t, axis=1)
        rexc_t = rinc_t - rlen_t
        onehot = ((rexc_t[:, None, :] <= kk[:, :, None])
                  & (kk[:, :, None] < rinc_t[:, None, :]))
        b = (run_start[tile_of] - rexc_t).astype(jnp.float32)
        pos = jnp.einsum("skr,sr->sk", onehot.astype(jnp.float32), b,
                         precision=lax.Precision.HIGHEST).astype(jnp.int32) \
            + kk
        src = stri[jnp.clip(pos, 0, T - 1).reshape(-1)]
        ids = jnp.where(slot_ok, src.reshape(s_cap, chunk), -1)
    else:
        # Slot -> source pair (gather from the sorted key array)
        pos = (bounds[tile_of] + k_of * chunk)[:, None] + jnp.arange(
            chunk, dtype=jnp.int32)[None, :]                   # [S, chunk]
        src = skey[jnp.clip(pos, 0, skey.shape[0] - 1).reshape(-1)]
        ids = jnp.where(slot_ok, src.reshape(s_cap, chunk) % T,
                        -1).astype(jnp.int32)

    overflow = (
        (total_chunks > s_cap)
        | jnp.any(setup.valid & ((span_y > m_y) | (span_x > m_x)))
    )

    # Occupied SHADE-BLOCK list for the compacted deferred-shade pass: a
    # shade block is one shade_w-wide pixel span of one row. Its occupancy
    # is bounded by the y- AND x-extent of the pair AABBs landing in its
    # tile — pixels outside can have no coverage. Row granularity beats
    # tile granularity by the silhouette factor (measured ~25-35% fewer
    # shaded pixels); sub-tile_w x granularity (SHADE_W) adds another
    # 10-30% on silhouette-heavy scenes (header comment).
    #
    # Extents are expanded by ROW_MARGIN so the cached rows list survives
    # small camera drift; check_queue_valid then requires every frame's
    # triangle AABB to stay inside its built (expanded) extents — the
    # tile-range check alone would let geometry drift onto blocks the
    # shade pass skips, leaving background holes with stale never firing.
    nsx = w // shade_w            # shade blocks per pixel row
    spt = tile_w // shade_w       # shade blocks per tile column
    n_rb = (nty * tile_h) * nsx   # shade blocks of the LOCAL output frame
    if t_cap is None or t_cap > n_rb:
        t_cap = n_rb
    ymin_tri = jnp.maximum(setup.min_y - ROW_MARGIN, 0)
    ymax_tri = jnp.minimum(setup.max_y + ROW_MARGIN, h)
    # per-tile extents over its pairs: dense masked reductions over the
    # [T, nT] coverage matrix.
    # NOTE: cov covers the triangle's FULL tile range while the queue
    # enumerates only m_y x m_x of it; the extents of beyond-span tiles
    # are a superset, which only ever ADDS blocks to the shade list (and
    # span overflow already sets the rebuild flag).
    ymin_t = jnp.min(jnp.where(cov, ymin_tri[:, None], h), axis=0)
    ymax_t = jnp.max(jnp.where(cov, ymax_tri[:, None], 0), axis=0)
    rbid = jnp.arange(n_rb, dtype=jnp.int32)
    rb_tile = (rbid // nsx // tile_h) * ntx + (rbid % nsx) // spt
    # Shade-block ids are LOCAL (they index the local output planes); the
    # occupancy test runs at the block's GLOBAL pixel row, since the
    # per-tile extents above are global-frame AABB facts. x is
    # interleave-invariant: local block x == global x.
    rb_ly = rbid // nsx
    rb_y = (rb_ly // tile_h * row_stride + row_offset) * tile_h \
        + rb_ly % tile_h
    occ_rb = ((counts[rb_tile] > 0)
              & (rb_y >= ymin_t[rb_tile]) & (rb_y < ymax_t[rb_tile]))
    if shade_w == tile_w:
        # A block's x-span IS its tile column, so tile containment already
        # bounds x: skip the four extra [T, nT] reductions and the x
        # occupancy terms — the entire extra per-frame rebuild cost of the
        # finer granularity (choose_shade_w weighs it).
        xmin_tri = jnp.zeros_like(ymin_tri)
        xmax_tri = jnp.full_like(ymax_tri, w)
    else:
        xmin_tri = jnp.maximum(setup.min_x - ROW_MARGIN, 0)
        xmax_tri = jnp.minimum(setup.max_x + ROW_MARGIN, w)
        xmin_t = jnp.min(jnp.where(cov, xmin_tri[:, None], w), axis=0)
        xmax_t = jnp.max(jnp.where(cov, xmax_tri[:, None], 0), axis=0)
        rb_x0 = (rbid % nsx) * shade_w
        occ_rb = (occ_rb
                  & (rb_x0 < xmax_t[rb_tile])
                  & (rb_x0 + shade_w > xmin_t[rb_tile]))
    occ_n = jnp.sum(occ_rb.astype(jnp.int32))
    rb_order = jnp.argsort(jnp.where(occ_rb, rbid, rbid + n_rb))[:t_cap]
    rows = jnp.where(jnp.arange(t_cap, dtype=jnp.int32) < occ_n,
                     rb_order, n_rb)
    overflow = overflow | (occ_n > t_cap)

    ranges = jnp.stack([ty0, ty1, tx0, tx1], axis=1)
    ylim = jnp.stack([ymin_tri, ymax_tri], axis=1)
    xlim = jnp.stack([xmin_tri, xmax_tri], axis=1)
    return Queue(ids=ids, tiles=tiles, ranges=ranges,
                 built_valid=setup.valid, overflow=overflow, rows=rows,
                 ylim=ylim, xlim=xlim, shade_w=StaticInt(shade_w))


def check_queue_valid(queue: Queue, setup: TriSetup,
                      tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Is the cached structure still a superset of this frame's coverage?

    True = safe to reuse (extra stale pairs are harmless: their edge tests
    exclude all pixels they no longer cover). False = triangles moved out of
    their binned tiles or flipped front-facing -> rebuild.
    """
    ty0, ty1, tx0, tx1 = tile_ranges(setup, tile_h, tile_w)
    r = queue.ranges
    inside = ((ty0 >= r[:, 0]) & (ty1 <= r[:, 1])
              & (tx0 >= r[:, 2]) & (tx1 <= r[:, 3])
              # y/x-extent within the built rows list's (expanded)
              # bounds — tile containment alone is not enough:
              # within-tile drift can cover shade blocks the compacted
              # shade pass would skip
              & (setup.min_y >= queue.ylim[:, 0])
              & (setup.max_y <= queue.ylim[:, 1])
              & (setup.min_x >= queue.xlim[:, 0])
              & (setup.max_x <= queue.xlim[:, 1]))
    ok = jnp.all(jnp.where(setup.valid,
                           inside & queue.built_valid, True))
    return ok & ~queue.overflow


NUM_WARPS = 8  # Triton warps per tile program


def _tables(setup, extra_f):
    """Per-triangle channel tables (tab_i i32 [T+1, _I_CH], tab_f f32
    [T+1, _F_CH + len(extra_f)]). Row T is all zeros: a degenerate AABB
    (max_x = max_y = 0) that admits no pixel, for empty slots.

    `setup` is a TriSetupP; `extra_f` a list of [T] f32 attribute channels
    in kernel order (base*n2, d10*n2, d20*n2, then the 3w triples)."""
    S = setup.C0 + setup.C1 + setup.C2
    ti = jnp.stack([setup.A0, setup.A1, setup.B0, setup.B1, setup.C0,
                    setup.C1, S, setup.min_x, setup.min_y, setup.max_x,
                    setup.max_y], axis=1)
    tf = jnp.stack([setup.bias0, setup.bias1, setup.bias2, setup.z0,
                    setup.z10, setup.z20, setup.inv_a2, *extra_f], axis=1)
    ti = jnp.concatenate([ti, jnp.zeros((1, _I_CH), jnp.int32)])
    tf = jnp.concatenate([tf, jnp.zeros((1, tf.shape[1]), jnp.float32)])
    return ti, tf


def _eval_pair(ci, cf, xs, ys, n2: int, n3: int, strict: bool):
    """Depth and attribute planes of a (tile, triangle) pair.

    ci(k) / cf(k) return int / float channel k of the triangle (a scalar
    in the kernel, a [P, 1, 1] batch in the XLA twin); xs / ys are the
    tile's pixel coordinates. Same integer edge math as the XLA oracle
    (28.4 fixed point, third edge from e0+e1+e2 = S, sign-OR inside test),
    then the reference's per-fragment f32 chains
    (rasterizer.rs:1695-1733), per-op rounded when `strict`.
    Returns (z, lins): z is +inf outside the triangle.
    """
    xf = xs << 4
    yf = ys << 4
    e0 = ci(0) * xf + ci(2) * yf + ci(4)
    e1 = ci(1) * xf + ci(3) * yf + ci(5)
    e2 = ci(6) - e0 - e1
    inside = (e0 | e1 | e2) >= 0
    in_box = (xs >= ci(7)) & (ys >= ci(8)) & (xs < ci(9)) & (ys < ci(10))
    inv_a2 = cf(6)
    # Integer de-bias, then ONE f32 rounding at the product
    # (rasterizer.rs:1695-1697); f channels 0..2 hold f32-encoded {1, 2}.
    b0 = (e0 - cf(0).astype(jnp.int32)).astype(jnp.float32) * inv_a2
    b1 = (e1 - cf(1).astype(jnp.int32)).astype(jnp.float32) * inv_a2
    b2 = (e2 - cf(2).astype(jnp.int32)).astype(jnp.float32) * inv_a2
    zz = (inv_a2 * 0.0).astype(jnp.int32) if strict else None
    zi = lerp_2mad(cf(3), cf(4), cf(5), b2, b0, zz)
    z = jnp.where(inside & in_box, zi, jnp.float32(jnp.inf))
    lins = []
    off = _F_CH
    for a in range(n2):
        lins.append(lerp_2mad(cf(off + a), cf(off + n2 + a),
                              cf(off + 2 * n2 + a), b2, b0, zz))
    off = _F_CH + 3 * n2
    for a in range(n3):
        lins.append(lerp_3w(cf(off + a), cf(off + n3 + a),
                            cf(off + 2 * n3 + a), b1, b2, b0, zz))
    return z, lins


def _queue_kernel(tiles_ref, ids_ref, tab_i_ref, tab_f_ref, z_ref, tri_ref,
                  *lin_refs, n2: int, n3: int, ntx: int, tile_h: int,
                  tile_w: int, strict: bool):
    """One program per tile: walk the tile's queue segment, keeping the
    lexicographic-min (z, triangle id) winner and its attribute planes."""
    t = pl.program_id(0) * ntx + pl.program_id(1)
    slot0 = tiles_ref[3 * t]
    cnt = tiles_ref[3 * t + 1]
    gty = tiles_ref[3 * t + 2]   # GLOBAL tile row
    shape = (tile_h, tile_w)
    xs = pl.program_id(1) * tile_w + lax.broadcasted_iota(jnp.int32, shape, 1)
    ys = gty * tile_h + lax.broadcasted_iota(jnp.int32, shape, 0)
    n_f = _F_CH + 3 * (n2 + n3)

    def body(p, st):
        z, win = st[0], st[1]
        tri = ids_ref[slot0 + p]
        zm, lins = _eval_pair(lambda k: tab_i_ref[tri * _I_CH + k],
                              lambda k: tab_f_ref[tri * n_f + k],
                              xs, ys, n2, n3, strict)
        upd = (zm < z) | ((zm == z) & (tri < win))
        return (jnp.where(upd, zm, z), jnp.where(upd, tri, win),
                *[jnp.where(upd, v, o) for v, o in zip(lins, st[2:])])

    # Background: depth 1.0 (rasterizer.rs:1954) with triangle id -1, so
    # it wins every tie — a fragment at exactly z == 1.0 stays hidden.
    init = (jnp.ones(shape, jnp.float32), jnp.full(shape, -1, jnp.int32),
            *[jnp.zeros(shape, jnp.float32) for _ in lin_refs])
    st = lax.fori_loop(0, cnt, body, init)
    z_ref[...] = st[0]
    tri_ref[...] = st[1]
    for r, v in zip(lin_refs, st[2:]):
        r[...] = v


@functools.partial(jax.jit, static_argnames=(
    "n2", "n3", "h", "w", "tile_h", "tile_w", "interpret", "num_warps"))
def raster_attrs_queue(
    queue: Queue, setup, extra_f, n2: int, n3: int,
    h: int, w: int, *, tile_h: int = TILE_H, tile_w: int = TILE_W,
    interpret: bool | None = None, num_warps: int = NUM_WARPS,
):
    """Rasterize + interpolate attribute planes through the flat queue.

    `setup` is a TriSetupP; `extra_f` a list/tuple of 3*(n2+n3) planar [T]
    attribute channels. Returns (z, mask, lins tuple, stale) — `stale` is
    True when the cached queue no longer covers this frame's geometry (or
    overflowed at build): the caller must rebuild the queue and re-render.
    Uncovered pixels read z = 1.0 and zero attribute planes.

    `interpret=None` asks core.platform.kernel_mode: compiled through
    Triton on a GPU, the Pallas interpreter on the CPU.
    """
    from ..core.platform import use_interpret

    if h % tile_h or w % tile_w:
        raise ValueError(f"frame {h}x{w} not divisible by {tile_h}x{tile_w}")
    assert len(extra_f) == 3 * (n2 + n3)
    ti, tf = _tables(setup, list(extra_f))
    nty, ntx = h // tile_h, w // tile_w
    n_planes = n2 + n3
    kernel = functools.partial(
        _queue_kernel, n2=n2, n3=n3, ntx=ntx, tile_h=tile_h, tile_w=tile_w,
        strict=strict_default())
    out_spec = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    outs = pl.pallas_call(
        kernel,
        grid=(nty, ntx),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=[out_spec] * (2 + n_planes),
        out_shape=([jax.ShapeDtypeStruct((h, w), jnp.float32),
                    jax.ShapeDtypeStruct((h, w), jnp.int32)]
                   + [jax.ShapeDtypeStruct((h, w), jnp.float32)] * n_planes),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=num_warps,
                                            num_stages=1),
        interpret=use_interpret(interpret),
        name="raster_queue",
    )(queue.tiles.reshape(-1), queue.ids.reshape(-1), ti.reshape(-1),
      tf.reshape(-1))
    stale = ~check_queue_valid(queue, setup, tile_h, tile_w)
    return outs[0], outs[1] >= 0, tuple(outs[2:]), stale


@functools.partial(jax.jit, static_argnames=(
    "n2", "n3", "h", "w", "tile_h", "tile_w", "chunk", "batch"))
def raster_attrs_queue_xla(
    queue: Queue, setup, extra_f, n2: int, n3: int,
    h: int, w: int, *, tile_h: int = TILE_H, tile_w: int = TILE_W,
    chunk: int = CHUNK, batch: int = 16,
):
    """Plain-XLA twin of raster_attrs_queue, same contract and bits.

    Per tile, each chunk of `chunk` pairs is evaluated at once and reduced
    by lexicographic min over (z, triangle id); the chunks of a tile
    combine by the same min, which is associative, so the winner equals the
    kernel's sequential race. The winners' attribute planes are selected
    from the chunk evaluation that produced them. `batch` tiles run at once.
    """
    if h % tile_h or w % tile_w:
        raise ValueError(f"frame {h}x{w} not divisible by {tile_h}x{tile_w}")
    assert len(extra_f) == 3 * (n2 + n3)
    ti, tf = _tables(setup, list(extra_f))
    T = ti.shape[0] - 1
    ids = queue.ids.reshape(-1)
    nty, ntx = h // tile_h, w // tile_w
    n_planes = n2 + n3
    strict = strict_default()
    shape = (tile_h, tile_w)
    iy = lax.broadcasted_iota(jnp.int32, shape, 0)
    ix = lax.broadcasted_iota(jnp.int32, shape, 1)
    big = jnp.int32(0x7FFFFFFF)

    def one_tile(args):
        t, seg = args
        slot0, cnt, gty = seg[0], seg[1], seg[2]
        xs = ((t % ntx) * tile_w + ix)[None]
        ys = (gty * tile_h + iy)[None]

        def chunk_body(c, st):
            p = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
            live = p < cnt
            tri = jnp.where(live, ids[jnp.clip(slot0 + p, 0, ids.shape[0] - 1)],
                            T)
            ri, rf = ti[tri], tf[tri]                        # [chunk, CH]
            zm, lins = _eval_pair(lambda k: ri[:, k, None, None],
                                  lambda k: rf[:, k, None, None],
                                  xs, ys, n2, n3, strict)
            trib = tri[:, None, None]
            zmin = jnp.min(zm, axis=0)
            at_min = zm == zmin[None]
            tmin = jnp.min(jnp.where(at_min, trib, big), axis=0)
            j = jnp.argmax(at_min & (trib == tmin[None]), axis=0)
            z, win = st[0], st[1]
            upd = (zmin < z) | ((zmin == z) & (tmin < win))
            picked = [jnp.take_along_axis(v, j[None], axis=0)[0] for v in lins]
            return (jnp.where(upd, zmin, z), jnp.where(upd, tmin, win),
                    *[jnp.where(upd, v, o) for v, o in zip(picked, st[2:])])

        init = (jnp.ones(shape, jnp.float32), jnp.full(shape, -1, jnp.int32),
                *[jnp.zeros(shape, jnp.float32) for _ in range(n_planes)])
        return lax.fori_loop(0, (cnt + chunk - 1) // chunk, chunk_body, init)

    outs = lax.map(one_tile, (jnp.arange(nty * ntx, dtype=jnp.int32),
                              queue.tiles), batch_size=batch)

    def untile(a):
        return a.reshape(nty, ntx, tile_h, tile_w).transpose(
            0, 2, 1, 3).reshape(h, w)

    outs = [untile(o) for o in outs]
    stale = ~check_queue_valid(queue, setup, tile_h, tile_w)
    return outs[0], outs[1] >= 0, tuple(outs[2:]), stale


def suggest_queue_config(setup_stats, margin: float = 1.3,
                         tile_margin: float = 1.15, chunk: int = CHUNK):
    """Static (s_cap, m_y, m_x, t_cap) from measured queue stats.

    The +1 span headroom and chunk margin absorb camera drift so cached
    structures can be rebuilt at nearby viewpoints without recompiling.
    t_cap (occupied-row-block capacity for the compacted shade) gets a
    smaller margin — its cost scales the per-pixel cubemap gathers directly.

    Caps are QUANTIZED (s_cap to 16 chunks, t_cap to 64 row-blocks) so
    nearby viewpoints produce the same static shapes: an unquantized cap
    changes with nearly every camera step, which would make every
    interactive rebuild a fresh XLA compile.

    Accepts queue_stats' 5-tuple (the tile_w-granular count is for
    choose_shade_w, not for capping) or the legacy 4-tuple; t_cap is
    sized from element [3] — pass the occupancy count matching the
    granularity the queue will be BUILT at.
    """
    total_chunks, sy, sx, occ_rows = setup_stats[:4]
    s_cap = max(16, -(-int(int(total_chunks) * margin + 4) // 16) * 16)
    t_cap = max(64, -(-int(int(occ_rows) * tile_margin + 8) // 64) * 64)
    return s_cap, int(sy) + 1, int(sx) + 1, t_cap


def queue_stats(setup: TriSetup, h: int, w: int,
                chunk: int = CHUNK, tile_h: int = TILE_H,
                tile_w: int = TILE_W, row_stride: int = 1,
                row_offset: int = 0):
    """(chunk count, max span_y, max span_x, occupied SHADE_W blocks,
    occupied tile_w blocks) for suggest_queue_config / choose_shade_w.

    The last two are the occupied compacted-shade block counts at the
    FINE (SHADE_W) and TILE (tile_w) granularities — both come from the
    same per-tile extents, so reporting both costs nothing extra, and
    callers pick the build granularity from their ratio (choose_shade_w)
    then cap with the matching element.

    `row_stride`/`row_offset` (static ints) restrict the stats to the
    cyclic-interleaved band's tiles — use the max over offsets for the
    unified caps of an interleaved shard (parallel/raster_shard.py).
    Span maxima stay GLOBAL: build_queue enumerates global spans.
    """
    nty_g, ntx = h // tile_h, w // tile_w
    nty = nty_g // row_stride
    ty0, ty1, tx0, tx1 = tile_ranges(setup, tile_h, tile_w)
    one = jnp.int32(1)
    span_y = jnp.where(setup.valid, ty1 - ty0 + 1, one)
    span_x = jnp.where(setup.valid, tx1 - tx0 + 1, one)

    # per-tile counts via the coverage matrix (build-time only)
    ty = jnp.arange(nty, dtype=jnp.int32) * row_stride + row_offset
    tx = jnp.arange(ntx, dtype=jnp.int32)
    cov_y = (ty[None, :] >= ty0[:, None]) & (ty[None, :] <= ty1[:, None])
    cov_x = (tx[None, :] >= tx0[:, None]) & (tx[None, :] <= tx1[:, None])
    cov = cov_y[:, :, None] & cov_x[:, None, :] & setup.valid[:, None, None]
    covf = cov.reshape(-1, nty * ntx)
    counts = covf.sum(axis=0).astype(jnp.int32)
    total_chunks = jnp.sum((counts + chunk - 1) // chunk)
    # occupied SHADE-BLOCK count: per tile, the pair AABBs' y-extent times
    # the SHADE_W-wide block span of their x-extent (with the same
    # ROW_MARGIN expansion build_queue bakes into Queue.rows) — the exact
    # per-tile block count build_queue's occupancy test produces.
    ymin_t = jnp.min(jnp.where(covf, jnp.maximum(
        setup.min_y - ROW_MARGIN, 0)[:, None], h), axis=0)
    ymax_t = jnp.max(jnp.where(covf, jnp.minimum(
        setup.max_y + ROW_MARGIN, h)[:, None], 0), axis=0)
    xmin_t = jnp.min(jnp.where(covf, jnp.maximum(
        setup.min_x - ROW_MARGIN, 0)[:, None], w), axis=0)
    xmax_t = jnp.max(jnp.where(covf, jnp.minimum(
        setup.max_x + ROW_MARGIN, w)[:, None], 0), axis=0)
    t_lo = ((jnp.arange(nty * ntx, dtype=jnp.int32) // ntx)
            * row_stride + row_offset) * tile_h   # GLOBAL first pixel row
    rows_per_tile = jnp.clip(
        jnp.minimum(ymax_t, t_lo + tile_h) - jnp.maximum(ymin_t, t_lo),
        0, tile_h)
    spt = tile_w // SHADE_W
    tb_lo = (jnp.arange(nty * ntx, dtype=jnp.int32) % ntx) * spt
    blk_lo = jnp.maximum(xmin_t // SHADE_W, tb_lo)
    blk_hi = jnp.minimum((jnp.maximum(xmax_t, 1) - 1) // SHADE_W,
                         tb_lo + spt - 1)
    blocks_per_row = jnp.clip(blk_hi - blk_lo + 1, 0, spt)
    occ_fine = jnp.sum(rows_per_tile * blocks_per_row)
    occ_tile = jnp.sum(rows_per_tile)
    return (total_chunks, jnp.max(span_y), jnp.max(span_x),
            occ_fine, occ_tile)
