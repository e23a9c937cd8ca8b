"""Randomized backend-equivalence fuzzing for the rasterizer.

The deterministic parity tests (test_raster.py) cover real scenes; these
push randomized and adversarial geometry through the whole-frame oracle,
the flat-queue kernel and its XLA twin and require BIT-equality. Failure categories this is designed to catch:
fill-convention drift on slivers and shared edges, backface/zero-area cull
disagreement, depth-tie winner divergence on coincident triangles, AABB
clipping at (and beyond) the frame border, and queue-cap/binning logic
under worst-case coverage. The reference tolerates none of these either —
its single scalar kernel is the oracle for all its threading modes
(rasterizer.rs:1518-1773 is shared by the serial and tiled paths).

All triangle soups share one static shape [T=96] so the jit cache is hit
across seeds (distinct compiles would dominate the suite's runtime).
"""

import numpy as np
import jax.numpy as jnp

from rustexp_tpu.assets import cubemap, mesh
from rustexp_tpu.ops import raster_queue as rq
from rustexp_tpu.ops.raster_setup import setup_triangles, setup_triangles_planar
from rustexp_tpu.ops.raster_xla import raster_gbuffer_xla
from rustexp_tpu.raster import camera, pipeline as pp

W, H = 128, 128
T = 96  # static soup size shared by every seed (one compile per backend)


def random_soup(seed: int):
    """[T] random viewport-space triangles with adversarial cases mixed in.

    Layout (all CCW-or-CW at random — backface culling must agree too):
      0..63   uniform random verts over [-20, dim+20) x z in [0, 1)
      64..71  duplicated pairs of soup triangles (exact z-ties: the
              deterministic winner rule must match across backends)
      72..79  zero-area: coincident or collinear vertices (must cull)
      80..87  slivers: sub-pixel-high spans dozens of pixels wide
      88..91  giant: covers the whole frame (exercises every tile)
      92..95  fully offscreen (AABB clip must reject identically)
    """
    rng = np.random.default_rng(seed)
    v = np.empty((T, 3, 3), np.float32)

    lo, hi = -20.0, 20.0
    v[:64, :, 0] = rng.uniform(lo, W + hi, (64, 3))
    v[:64, :, 1] = rng.uniform(lo, H + hi, (64, 3))
    v[:64, :, 2] = rng.uniform(0.0, 1.0, (64, 3))

    dup_src = rng.choice(64, 8, replace=False)
    v[64:72] = v[dup_src]

    base = np.stack([rng.uniform(0, W, 8), rng.uniform(0, H, 8),
                     rng.uniform(0, 1, 8)], axis=-1).astype(np.float32)
    v[72:76] = base[:4, None, :]                      # 3 coincident verts
    for i in range(4):                                 # collinear verts
        a = base[4 + i]
        d = rng.uniform(-30, 30, 3).astype(np.float32)
        d[2] = 0.0
        v[76 + i] = np.stack([a, a + d, a + 2 * d])

    for i in range(8):                                 # slivers
        x0 = rng.uniform(0, W - 80)
        y0 = rng.uniform(1, H - 2)
        z = rng.uniform(0, 1)
        v[80 + i] = [[x0, y0, z], [x0 + 70, y0 + 0.3, z],
                     [x0 + 35, y0 + 0.6, z]]

    for i in range(4):                                 # giant, both windings
        z = rng.uniform(0, 1)
        tri = [[-2.0 * W, -2.0 * H, z], [4.0 * W, -2.0 * H, z],
               [0.5 * W, 4.0 * H, z]]
        v[88 + i] = tri if i % 2 == 0 else tri[::-1]

    v[92:94, :, 0] = rng.uniform(W + 50, W + 200, (2, 3))  # right of frame
    v[92:94, :, 1] = rng.uniform(0, H, (2, 3))
    v[94:96, :, 0] = rng.uniform(0, W, (2, 3))
    v[94:96, :, 1] = rng.uniform(-200, -50, (2, 3))        # below frame
    v[92:96, :, 2] = rng.uniform(0, 1, (4, 3))

    vp = np.ones((T * 3, 4), np.float32)
    vp[:, :3] = v.reshape(T * 3, 3)
    tris = np.arange(T * 3, dtype=np.int32).reshape(T, 3)
    return jnp.asarray(vp), jnp.asarray(tris)


def _queue_gbuffer(vp, tris, raster):
    """(z, winning triangle id) through the flat queue: the id rides a
    2-MAD attribute channel (id, 0, 0), which interpolates to itself."""
    c = vp[tris.reshape(-1)].reshape(T, 3, 4)
    sp = setup_triangles_planar(c[:, :, 0].T, c[:, :, 1].T, c[:, :, 2].T,
                                W, H)
    stats = tuple(int(x) for x in rq.queue_stats(sp, H, W))
    s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
    q = rq.build_queue(sp, H, W, s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap)
    zero = jnp.zeros((T,), jnp.float32)
    tid = jnp.arange(T, dtype=jnp.float32)
    z, mask, (lin,), stale = raster(q, sp, (tid, zero, zero), 1, 0, H, W)
    assert not bool(stale)
    ids = np.where(np.asarray(mask), np.asarray(lin).astype(np.int32), -1)
    return np.asarray(z), ids


def test_gbuffer_backends_bit_equal_on_fuzz_soups():
    for seed in range(4):
        vp, tris = random_soup(seed)
        s = setup_triangles(vp, tris, W, H)
        gx = raster_gbuffer_xla(s, H, W)
        for name, raster in (("kernel", rq.raster_attrs_queue),
                             ("twin", rq.raster_attrs_queue_xla)):
            z, tid = _queue_gbuffer(vp, tris, raster)
            for f, a, b in (("tid", np.asarray(gx.tid), tid),
                            ("z", np.asarray(gx.z), z)):
                assert np.array_equal(a, b), (
                    f"seed {seed} {name} {f}: {np.argwhere(a != b)[:4]}")
        # Sanity: the soup actually rasterized something and culled the
        # offscreen/degenerate cases (a trivially-empty frame would make
        # the equality vacuous).
        tid = np.asarray(gx.tid)
        assert (tid >= 0).any(), f"seed {seed}: nothing covered"
        # Coincident-vertex triangles snap to identical 28.4 coords ->
        # exactly zero area -> must cull. (The COLLINEAR cases 76..80 may
        # legally cover pixels: float collinearity can break under the
        # truncating fixed-point snap, leaving a +-1-subpixel-area sliver
        # — the reference's scalar kernel behaves identically.)
        assert not np.isin(tid[tid >= 0], np.arange(72, 76)).any(), \
            f"seed {seed}: coincident-vertex triangle won a pixel"
        assert not np.isin(tid[tid >= 0], np.arange(92, 96)).any(), \
            f"seed {seed}: offscreen triangle won a pixel"


def jittered_scene(seed: int, amp: float):
    """A sphere whose vertices are randomly displaced: irregular geometry
    with inverted windings and slivers, but still a valid Scene for the
    full render_frame paths."""
    rng = np.random.default_rng(seed)
    m = mesh.make_sphere(8, 16)
    pos = (np.asarray(m.positions)
           + rng.normal(0, amp, m.positions.shape)).astype(np.float32)
    jm = mesh.MeshData(positions=pos, normals=m.normals, colors=m.colors,
                       tris=m.tris, name=f"fuzz{seed}")
    return pp.make_scene(jm, cubemap.make_procedural_set())


def test_sharded_queue_matches_single_device_on_jittered_mesh():
    # The production multi-device path on irregular geometry: per-band
    # queues + integer band translation must reproduce the single-device
    # queue render bit-exactly even for slivers crossing band boundaries.
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from rustexp_tpu.parallel import raster_shard

    scene = jittered_scene(3, 0.12)
    eye = jnp.asarray(camera.cam_orbit(0.5))
    queue1 = pp.build_scene_queue(scene, eye, W, H)
    want, stale1 = pp.render_frame(scene, eye, 0.5, w=W, h=H, shader_idx=5,
                                   show_cm=False, per_pixel=True,
                                   backend="queue", raster_queue=queue1,
                                   return_overflow=True)
    assert not bool(stale1)
    mesh_dev = Mesh(np.array(jax.devices()[:4]), axis_names=("rows",))
    queues = raster_shard.build_band_queues(scene, eye, w=W, h=H, n_dev=4)
    queues = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh_dev, P("rows"))),
        queues)
    render = raster_shard.make_sharded_queue_render(
        mesh_dev, scene, eye, w=W, h=H, per_pixel=True, shader_idx=5)
    got, stale = render(scene, queues, eye, jnp.float32(0.5))
    assert not bool(stale)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_queue_matches_pallas_on_jittered_meshes():
    # The production queue backend against the whole-frame oracle on
    # deformed geometry, both shading modes, bit-exact. Queue caps are
    # auto-sized per scene (build_scene_queue), so this also fuzzes the
    # cap-suggestion logic against irregular coverage.
    eye = camera.cam_orbit(0.7)
    for seed, amp in ((1, 0.05), (2, 0.15)):
        scene = jittered_scene(seed, amp)
        queue = pp.build_scene_queue(scene, eye, W, H)
        for ppx in (False, True):
            kw = dict(w=W, h=H, shader_idx=5, show_cm=False, per_pixel=ppx)
            a = np.asarray(pp.render_frame(scene, eye, 0.7,
                                           backend="xla", **kw))
            b, stale = pp.render_frame(scene, eye, 0.7, backend="queue",
                                       raster_queue=queue,
                                       return_overflow=True, **kw)
            assert not bool(stale), f"seed {seed} per_pixel={ppx}"
            assert np.array_equal(a, np.asarray(b)), \
                f"seed {seed} amp={amp} per_pixel={ppx}"
