"""Multi-device rasterization: row-band frame sharding over a device Mesh.

Mesh scaling of the reference's tile-parallel Fill path
(rasterizer.rs:2074-2198, P4 in SURVEY.md §2.4): the framebuffer is split
into horizontal bands, one per device. Vertex processing is replicated
(cheap — one batched matmul), each device bins and rasterizes only the
triangles overlapping its band, then shades locally; no inter-device
communication is needed at all (tile exclusivity), so the only collective
is the implicit final gather when the caller assembles the frame.

The band translation trick keeps fixed-point parity: shifting viewport
coordinates by an integer row offset before the 28.4 snap commutes with
truncation, so band-local rasterization is bit-identical to the
corresponding rows of a single-device render.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..ops.raster_setup import setup_triangles
from ..ops.raster_xla import raster_gbuffer_xla
from ..raster import pipeline as pp


def make_sharded_render(
    mesh: Mesh,
    *,
    w: int,
    h: int,
    per_pixel: bool = False,
    shader_idx: int = 5,
    bg_idx: int = 0,
    axis="rows",
):
    """Build a jitted (scene, eye, tick) -> fb renderer sharded over `axis`
    through the whole-frame XLA oracle (each band rasterizes every
    triangle over its own rows).

    The returned framebuffer is row-sharded across the mesh; callers can
    keep computing on it sharded or pull it to host for display. The
    production sharded path is make_sharded_queue_render.
    """
    from .gol_shard import axis_size

    n_dev = axis_size(mesh, axis)
    if h % n_dev:
        raise ValueError(f"frame height {h} not divisible by {n_dev} devices")
    band_h = h // n_dev

    def band_render(scene: pp.Scene, eye, tick):
        dev = jax.lax.axis_index(axis)

        vp, world, n_world = pp.transform_vertices(scene, eye, w, h)
        colors = scene.colors
        if not per_pixel:
            colors = pp.sh.shader_fn(shader_idx)(
                world, n_world, scene.colors, eye, tick, scene.cm
            )
        # Integer band translation AFTER the global snap: bit-exact even
        # when the float-side translation would cross zero (trunc-to-zero
        # vs floor — see ops/raster_setup.setup_triangles_planar)
        setup = setup_triangles(vp, scene.tris, w, band_h,
                                y_shift=dev * band_h)
        gb = raster_gbuffer_xla(setup, band_h, w)

        # Band slice of the vertical gradient, evaluated at global rows
        bg = pp.background(bg_idx, w, band_h, y0=dev * band_h, full_h=h)

        # Shading interpolates from *untranslated* vertex attributes; the
        # barycentrics are translation-invariant so this is exact.
        return pp.shade_gbuffer(
            gb, scene, vp, world, n_world, colors, eye, tick,
            per_pixel=per_pixel, shader_idx=shader_idx, bg_fb=bg,
        )

    replicated = P()
    fn = shard_map(
        band_render,
        mesh=mesh,
        in_specs=(replicated, replicated, replicated),
        out_specs=P(axis, None),
        check_rep=False,
    )
    return jax.jit(fn, out_shardings=NamedSharding(mesh, P(axis, None)))


def render_frame_sharded(scene, eye, tick, mesh: Mesh, **kw):
    """One-shot convenience wrapper around make_sharded_render."""
    fn = make_sharded_render(mesh, **kw)
    return fn(scene, jnp.asarray(eye, jnp.float32), jnp.float32(tick))


# ---------------------------------------------------------------------------
# Flat-queue band sharding — the PRODUCTION raster path over the mesh.
# ---------------------------------------------------------------------------


def interleave_y_rows(band_h: int, n_dev: int, dev, tile_h: int):
    """GLOBAL pixel row of each local row of a cyclic-interleaved band.

    Device `dev` (may be a traced axis index) owns the global tile rows
    g with g % n_dev == dev; local row ly sits in local tile row
    ly // tile_h, hence global row (ly//tile_h * n_dev + dev)*tile_h +
    ly % tile_h.
    """
    ly = jnp.arange(band_h, dtype=jnp.int32)
    return (ly // tile_h * n_dev + dev) * tile_h + ly % tile_h


def deinterleave_rows(fb, n_dev: int, tile_h: int):
    """Reassemble the global frame from a cyclic-interleaved stack.

    `fb` is the [h, w] array a P(axis, None) out_spec produces from
    cyclic bands: device-major, i.e. row block d*band_h + lt*tile_h holds
    global tile row lt*n_dev + d. One relayout undoes it.
    """
    h, w = fb.shape[0], fb.shape[1]
    band_h = h // n_dev
    nty_l = band_h // tile_h
    x = fb.reshape((n_dev, nty_l, tile_h) + fb.shape[1:])
    return jnp.swapaxes(x, 0, 1).reshape(fb.shape)


def band_queue_caps(scene, eyes, *, w: int, h: int, n_dev: int,
                    layout: str = "bands"):
    """UNIFIED static queue caps over sampled eyes x all bands.

    Caps are the max over every (eye, band) pair so one compiled program
    serves the whole camera path on every device; suggest_queue_config's
    margin + quantization absorb drift between the sampled eyes.
    `layout="cyclic"` measures the cyclic tile-row interleave's bands
    instead of contiguous ones (global setup, strided queue_stats).
    """
    from ..ops.raster_queue import queue_stats, suggest_queue_config
    from ..ops.raster_setup import setup_triangles_planar

    band_h = h // n_dev

    if layout == "cyclic":
        @jax.jit
        def g_setup(scene, eye):
            xs, ys, zs, _, _, _ = pp.transform_corners_planar(
                scene, eye, w, h)
            return setup_triangles_planar(xs, ys, zs, w, h)

        stats_jit = jax.jit(
            queue_stats,
            static_argnames=("h", "w", "row_stride", "row_offset"))
        stats = [jax.device_get(stats_jit(
            g_setup(scene, jnp.asarray(e, jnp.float32)), h=h, w=w,
            row_stride=n_dev, row_offset=d))
            for e in eyes for d in range(n_dev)]
    else:
        @partial(jax.jit, static_argnums=(2,))
        def band_setup(scene, eye, d):
            xs, ys, zs, _, _, _ = pp.transform_corners_planar(
                scene, eye, w, h)
            return setup_triangles_planar(xs, ys, zs, w, band_h,
                                          y_shift=d * band_h)

        stats_jit = jax.jit(queue_stats, static_argnums=(1, 2))
        stats = [jax.device_get(stats_jit(
            band_setup(scene, jnp.asarray(e, jnp.float32), d), band_h, w))
            for e in eyes for d in range(n_dev)]
    agg = tuple(max(int(s[j]) for s in stats) for j in range(4))
    return suggest_queue_config(agg)


def build_band_queues(scene, eye, *, w: int, h: int, n_dev: int,
                      margin: float = 1.3, layout: str = "bands"):
    """Per-band flat queues with UNIFIED static caps, stacked on axis 0.

    layout="bands": each band builds its queue from the band-translated
    planar setup (the integer y translation commutes with the 28.4
    truncating snap, so band structures match the corresponding rows of a
    whole-frame build). layout="cyclic": each device owns every n_dev-th
    tile row (build_queue row_stride/row_offset) — bounded load imbalance
    on dense center-heavy meshes. Caps are the max over bands so every
    device runs the same static shapes; the stacked Queue pytree shards
    its leading axis over the device mesh.
    """
    from ..ops.raster_queue import build_queue
    from ..ops.raster_setup import setup_triangles_planar

    band_h = h // n_dev
    eye = jnp.asarray(eye, jnp.float32)
    s_cap, m_y, m_x, t_cap = band_queue_caps(scene, [eye], w=w, h=h,
                                             n_dev=n_dev, layout=layout)

    @partial(jax.jit, static_argnums=(2,))
    def band_queue(scene, eye, d):
        xs, ys, zs, _, _, _ = pp.transform_corners_planar(scene, eye, w, h)
        if layout == "cyclic":
            setup = setup_triangles_planar(xs, ys, zs, w, h)
            return build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                               t_cap=t_cap, row_stride=n_dev, row_offset=d)
        setup = setup_triangles_planar(xs, ys, zs, w, band_h,
                                       y_shift=d * band_h)
        return build_queue(setup, band_h, w,
                           s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap)

    queues = [band_queue(scene, eye, d) for d in range(n_dev)]
    return jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *queues)


def _queue_band_core(mesh, *, w: int, h: int, per_pixel: bool,
                     shader_idx: int, bg_idx: int, axis, caps=None,
                     layout: str = "bands"):
    """Shared per-band body for the flat-queue renderers.

    caps=None: the queue arrives prebuilt (stacked pytree, cached across
    frames). caps=(s_cap, m_y, m_x, t_cap): the queue is REBUILT IN-GRAPH
    from this frame's setup — the sharded moving-camera path.

    layout="bands": contiguous row bands via post-snap integer
    translation. layout="cyclic": each device owns every n_dev-th TILE
    ROW (build_queue row_stride/row_offset — edge functions evaluate at
    global coordinates through the queue's global-tile-row scalar), which
    bounds the band-imbalance of center-heavy meshes to per-tile-row
    variance: contiguous bands give middle devices the silhouette-dense
    rows. Reference analog: its sort-tiles-by-bin-size
    schedule, rasterizer.rs:2165-2167. Either layout's band output is
    bit-identical to the same global rows of a whole-frame render; cyclic
    output needs deinterleave_rows() to reassemble the frame.
    """
    from ..core.colors import pack_abgr32_gamma_arith
    from ..core.platform import use_interpret
    from ..ops.raster_queue import TILE_H, build_queue, raster_attrs_queue
    from ..ops.raster_setup import setup_triangles_planar

    from .gol_shard import axis_size

    n_dev = axis_size(mesh, axis)
    if h % n_dev:
        raise ValueError(f"frame height {h} not divisible by {n_dev} devices")
    band_h = h // n_dev
    cyclic = layout == "cyclic"
    if cyclic and (h // TILE_H) % n_dev:
        raise ValueError(
            f"{h // TILE_H} tile rows not divisible by {n_dev} devices")
    # Follow the MESH's platform, not the process default backend (a CPU
    # mesh in a GPU process interprets).
    interpret = use_interpret(None, mesh.devices.flat[0].platform)

    def band_render(scene, queue, eye, tick):
        if caps is None:
            queue = jax.tree_util.tree_map(lambda x: x[0], queue)
        dev = jax.lax.axis_index(axis)
        y_org = (dev * band_h).astype(jnp.float32)
        y_rows = interleave_y_rows(band_h, n_dev, dev, TILE_H) \
            if cyclic else None

        xs, ys, zs, iw, n_c, world_c = pp.transform_corners_planar(
            scene, eye, w, h)
        if cyclic:
            # GLOBAL setup: the interleaved queue carries global tile
            # rows, so no translation is needed (or possible — the owned
            # rows aren't contiguous).
            setup = setup_triangles_planar(xs, ys, zs, w, h)
        else:
            # Post-snap integer translation (bit-exact at band boundaries)
            setup = setup_triangles_planar(xs, ys, zs, w, band_h,
                                           y_shift=dev * band_h)

        if caps is not None:
            if cyclic:
                queue = build_queue(setup, h, w, s_cap=caps[0],
                                    m_y=caps[1], m_x=caps[2], t_cap=caps[3],
                                    row_stride=n_dev, row_offset=dev)
            else:
                queue = build_queue(setup, band_h, w, s_cap=caps[0],
                                    m_y=caps[1], m_x=caps[2], t_cap=caps[3])

        colors = None
        if not per_pixel:
            # Replicated per-vertex shading (cheap one-batch work) —
            # identical to the single-device V path.
            _, world, n_world = pp.transform_vertices(scene, eye, w, h)
            colors = pp.sh.shader_fn(shader_idx)(
                world, n_world, scene.colors, eye, tick, scene.cm)
        extra, n2, n3 = pp.queue_attr_channels(scene, iw, n_c, world_c,
                                               colors, per_pixel)
        z, maskp, lin, stale = raster_attrs_queue(queue, setup, tuple(extra),
                                                  n2, n3, band_h, w,
                                                  interpret=interpret)

        # Band slice of the vertical gradient at GLOBAL rows
        bg = pp.background(bg_idx, w, band_h, y0=dev * band_h, full_h=h,
                           y_rows=y_rows)

        if per_pixel:
            fb = pp._shade_compacted(queue.rows, scene, z, maskp, lin, eye,
                                     tick, shader_idx, bg, w, band_h, True,
                                     y0=y_org, full_h=h, y_rows=y_rows,
                                     block_w=int(queue.shade_w))
        else:
            wr = 1.0 / lin[0]
            c = jnp.stack([q * wr for q in lin[1:4]], axis=-1)
            packed = pack_abgr32_gamma_arith(c[..., 0], c[..., 1], c[..., 2])
            fb = jnp.where(maskp, packed, bg)
        any_stale = jax.lax.pmax(stale.astype(jnp.int32), axis) > 0
        return fb, any_stale

    return band_render


def make_sharded_queue_render(
    mesh: Mesh,
    scene,
    eye,
    *,
    w: int,
    h: int,
    per_pixel: bool = False,
    shader_idx: int = 5,
    bg_idx: int = 0,
    axis="rows",
    layout: str = "bands",
):
    """Jitted (scene, queues, eye, tick) -> (fb, stale) over the flat-queue
    kernel, one band per device.

    Build the stacked `queues` with build_band_queues (cacheable across
    frames exactly like the single-chip queue; pass the SAME `layout`);
    `stale` is the any-reduced rebuild flag. Per band: replicated planar
    transform, integer band translation (or the cyclic tile-row
    interleave, layout="cyclic"), local raster_attrs_queue + compacted
    shade with global ray coordinates — output rows are bit-identical to
    the single-device queue render of the same frame (cyclic frames
    reassemble via deinterleave_rows).
    """
    band_render = _queue_band_core(mesh, w=w, h=h, per_pixel=per_pixel,
                                   shader_idx=shader_idx, bg_idx=bg_idx,
                                   axis=axis, layout=layout)
    fn = shard_map(
        band_render,
        mesh=mesh,
        # P(axis) is a pytree-PREFIX spec: it broadcasts over every array
        # leaf of the stacked Queue (shade_w is structure data, no leaf —
        # a tree_map'd per-leaf spec would need the dummy's aux to match
        # the real queue's granularity).
        in_specs=(P(), P(axis), P(), P()),
        out_specs=(P(axis, None), P()),
        check_rep=False,
    )
    out_sharding = (NamedSharding(mesh, P(axis, None)),
                    NamedSharding(mesh, P()))
    return jax.jit(fn, out_shardings=out_sharding)


def make_sharded_queue_render_moving(
    mesh: Mesh,
    scene,
    cap_eyes,
    *,
    w: int,
    h: int,
    per_pixel: bool = False,
    shader_idx: int = 5,
    bg_idx: int = 0,
    axis="rows",
    layout: str = "bands",
):
    """Jitted (scene, eye, tick) -> (fb, stale): per-frame IN-GRAPH band
    queue rebuild — the sharded moving-camera path, zero host trips.

    The single-device analog is the full in-graph rebuild scan
    (app/benchmark.py bench_scene_moving); here each device rebuilds only ITS band's queue from this
    frame's translated setup, so the per-chip build cost is ~1/D of the
    single-chip rebuild. Static caps come from `cap_eyes` (sample the
    camera path) via band_queue_caps; `stale`=True means the camera left
    the sampled caps (triangles would be dropped) — re-make with wider
    cap_eyes rather than looping. Output rows are bit-identical to the
    single-device queue render of the same frame.
    """
    from .gol_shard import axis_size

    caps = band_queue_caps(scene, cap_eyes, w=w, h=h,
                           n_dev=axis_size(mesh, axis), layout=layout)
    band_render = _queue_band_core(mesh, w=w, h=h, per_pixel=per_pixel,
                                   shader_idx=shader_idx, bg_idx=bg_idx,
                                   axis=axis, caps=caps, layout=layout)
    fn = shard_map(
        lambda scene, eye, tick: band_render(scene, None, eye, tick),
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(axis, None), P()),
        check_rep=False,
    )
    out_sharding = (NamedSharding(mesh, P(axis, None)),
                    NamedSharding(mesh, P()))
    return jax.jit(fn, out_shardings=out_sharding)


