"""Rasterizer tests: setup, G-buffer oracle vs the flat-queue kernel,
shading, modes, cameras, and the benchmark table."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rustexp_tpu.assets import cubemap, mesh
from rustexp_tpu.ops.raster_setup import setup_triangles
from rustexp_tpu.ops.raster_xla import raster_gbuffer_xla
from rustexp_tpu.ops import raster_queue as rq
from rustexp_tpu.ops.raster_setup import setup_triangles_planar
from rustexp_tpu.raster import camera, pipeline as pp, shaders as sh

W, H = 128, 128  # queue-tileable test frame


def _planar(vp, tris, w=W, h=H):
    """Planar setup from indexed viewport vertices."""
    c = [vp[tris[:, j]] for j in range(3)]
    return setup_triangles_planar(jnp.stack([v[:, 0] for v in c]),
                                  jnp.stack([v[:, 1] for v in c]),
                                  jnp.stack([v[:, 2] for v in c]), w, h)


def _queue_for(setup, h=H, w=W, **kw):
    stats = tuple(int(x) for x in rq.queue_stats(setup, h, w))
    s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
    return rq.build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                          t_cap=t_cap, **kw)


def _tile_sets(q):
    """{tile index: sorted triangle ids} from a Queue's segment table."""
    ids = np.asarray(q.ids).reshape(-1)
    out = {}
    for t, (s0, cnt, _) in enumerate(np.asarray(q.tiles)):
        if cnt:
            out[t] = sorted(ids[s0:s0 + cnt].tolist())
    return out


def _vp(verts):
    """Build a viewport-space vertex array [V,4] with 1/w=1 (no perspective)."""
    v = np.asarray(verts, dtype=np.float32)
    out = np.ones((len(v), 4), dtype=np.float32)
    out[:, :3] = v
    return jnp.asarray(out)


def one_tri(z=0.5):
    # CCW in bottom-left viewport coords
    return _vp([[10, 10, z], [100, 10, z], [10, 100, z]]), jnp.array([[0, 1, 2]],
                                                                     dtype=jnp.int32)


class TestSetup:
    def test_front_facing(self):
        vp, tris = one_tri()
        s = setup_triangles(vp, tris, W, H)
        assert bool(s.valid[0])
        # reversed winding is culled
        s2 = setup_triangles(vp, tris[:, ::-1], W, H)
        assert not bool(s2.valid[0])

    def test_aabb(self):
        vp, tris = one_tri()
        s = setup_triangles(vp, tris, W, H)
        assert int(s.min_x[0]) == 10 and int(s.min_y[0]) == 10
        assert int(s.max_x[0]) == 100 and int(s.max_y[0]) == 100


class TestGBuffer:
    def test_coverage_and_barycentrics(self):
        vp, tris = one_tri(z=0.25)
        gb = raster_gbuffer_xla(setup_triangles(vp, tris, W, H), H, W)
        tid = np.asarray(gb.tid)
        assert tid[20, 20] == 0      # inside
        assert tid[20, 110] == -1    # outside
        assert tid[110, 20] == -1
        z = np.asarray(gb.z)
        assert abs(z[20, 20] - 0.25) < 1e-5
        b = np.asarray(gb.b)[20, 20]
        assert abs(b.sum() - 1.0) < 1e-3
        assert np.all(b >= -1e-3)

    def test_depth_order_and_ties(self):
        # Two stacked triangles: nearer one must win; equal z -> first wins
        vp = _vp([[10, 10, 0.5], [100, 10, 0.5], [10, 100, 0.5],
                  [10, 10, 0.2], [100, 10, 0.2], [10, 100, 0.2]])
        tris = jnp.array([[0, 1, 2], [3, 4, 5]], dtype=jnp.int32)
        gb = raster_gbuffer_xla(setup_triangles(vp, tris, W, H), H, W)
        assert np.asarray(gb.tid)[20, 20] == 1
        vp_eq = _vp([[10, 10, 0.5], [100, 10, 0.5], [10, 100, 0.5]] * 2)
        gb2 = raster_gbuffer_xla(setup_triangles(vp_eq, tris, W, H), H, W)
        assert np.asarray(gb2.tid)[20, 20] == 0

    def test_shared_edge_deterministic(self):
        # Two triangles sharing a diagonal edge. The reference's sign-OR
        # bias admits exact-boundary pixels into BOTH triangles
        # (rasterizer.rs:1630-1634: stored e = e_true + fill_bias + 1, test
        # >= 0), and the strict depth test then keeps the first-submitted
        # one (rasterizer.rs:1704-1708). Verify that deterministic outcome.
        vp = _vp([[10, 10, 0.5], [100, 10, 0.5], [100, 100, 0.5], [10, 100, 0.5]])
        tris = jnp.array([[0, 1, 2], [0, 2, 3]], dtype=jnp.int32)
        s = setup_triangles(vp, tris, W, H)
        gb_a = raster_gbuffer_xla(setup_triangles(vp, tris[:1], W, H), H, W)
        gb_b = raster_gbuffer_xla(setup_triangles(vp, tris[1:], W, H), H, W)
        cov_a = np.asarray(gb_a.tid) >= 0
        cov_b = np.asarray(gb_b.tid) >= 0
        both = raster_gbuffer_xla(s, H, W)
        tid = np.asarray(both.tid)
        assert np.array_equal(tid >= 0, cov_a | cov_b)
        # The full quad interior is covered with no holes along the diagonal
        assert np.all(tid[20:90, 20:90] >= 0)
        # Contested (double-claimed) pixels resolve to the first triangle
        assert np.all(tid[cov_a & cov_b] == 0)
        # On the exact diagonal the first-submitted triangle wins
        assert tid[50, 50] == 0

    def test_pallas_matches_xla(self):
        # The flat-queue kernel's depth and coverage equal the oracle's.
        m = mesh.make_sphere(12, 24)
        scene = pp.make_scene(m, cubemap.make_procedural_set())
        eye = camera.cam_orbit(0.7)
        vp, _, _ = pp.transform_vertices(scene, jnp.asarray(eye), W, H)
        gx = raster_gbuffer_xla(setup_triangles(vp, scene.tris, W, H), H, W)
        sp = _planar(vp, scene.tris)
        q = _queue_for(sp)
        z, mask, _, stale = rq.raster_attrs_queue(q, sp, (), 0, 0, H, W,
                                                  interpret=True)
        assert not bool(stale)
        assert np.array_equal(np.asarray(gx.tid) >= 0, np.asarray(mask))
        assert np.array_equal(np.asarray(gx.z), np.asarray(z))

    def test_pairs_binning_matches_dense(self):
        # Every queue order bins exactly the tiles of each triangle's
        # pixel AABB (the dense coverage matrix), for spans within budget.
        m = mesh.make_sphere(10, 20)
        scene = pp.make_scene(m, cubemap.make_procedural_set())
        vp, _, _ = pp.transform_vertices(
            scene, jnp.asarray(camera.cam_orbit(0.3)), W, H)
        sp = _planar(vp, scene.tris)
        ty0, ty1, tx0, tx1 = (np.asarray(a) for a in rq.tile_ranges(sp))
        valid = np.asarray(sp.valid)
        ntx = W // rq.TILE_W
        want = {}
        for i in np.nonzero(valid)[0]:
            for ty in range(ty0[i], ty1[i] + 1):
                for tx in range(tx0[i], tx1[i] + 1):
                    want.setdefault(ty * ntx + tx, []).append(int(i))
        for order in ("tri", "plane", "direct"):
            q = _queue_for(sp, order=order)
            assert not bool(q.overflow)
            assert _tile_sets(q) == want, order

    def test_pairs_binning_overflow_flag(self):
        vp, tris = one_tri()  # AABB rows [10, 100)
        rows = 99 // rq.TILE_H - 10 // rq.TILE_H + 1   # tile rows spanned
        sp = _planar(vp, tris)
        kw = dict(s_cap=16, m_x=1, t_cap=None)
        assert bool(rq.build_queue(sp, H, W, m_y=rows - 1, **kw).overflow)
        assert not bool(rq.build_queue(sp, H, W, m_y=rows, **kw).overflow)

    def test_binning_counts(self):
        vp, tris = one_tri()
        q = _queue_for(_planar(vp, tris))
        counts = np.asarray(q.tiles)[:, 1]
        # AABB [10,100)x[10,100): one tile column, one pair per tile row
        assert counts.sum() == 99 // rq.TILE_H - 10 // rq.TILE_H + 1
        assert not bool(q.overflow)


class TestShaders:
    def _frag(self):
        p = jnp.array([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0]], dtype=jnp.float32)
        n = jnp.array([[0.0, 1.0, 0.0], [1.0, 1.0, 0.0]], dtype=jnp.float32)
        col = jnp.full((2, 3), 0.5, dtype=jnp.float32)
        eye = jnp.array([1.8, 0.0, 0.0], dtype=jnp.float32)
        cm = jnp.asarray(cubemap.make_procedural_set().data)
        return p, n, col, eye, 0.3, cm

    def test_all_shaders_finite(self):
        args = self._frag()
        for i in range(sh.NUM_SHADERS):
            out = np.asarray(sh.shader_fn(i)(*args))
            assert out.shape == (2, 3), sh.shader_name(i)
            assert np.all(np.isfinite(out)), sh.shader_name(i)

    def test_baked_color_passthrough(self):
        p, n, col, eye, tick, cm = self._frag()
        assert np.allclose(sh.shader_color(p, n, col, eye, tick, cm), col)

    def test_normals_shader_range(self):
        p, n, col, eye, tick, cm = self._frag()
        out = np.asarray(sh.shader_n_to_color(p, n, col, eye, tick, cm))
        assert np.all(out >= 0.0) and np.all(out <= 1.0)

    def test_cm_lookup_faces(self):
        # Distinct color per face; axis directions must hit the right face
        data = np.zeros((5, 6, 64, 64, 3), dtype=np.float32)
        for f in range(6):
            data[:, f] = f + 1
        cm = jnp.asarray(data)
        dirs = jnp.array(
            [[1, 0.1, 0.1], [-1, 0.1, 0.1], [0.1, 1, 0.1],
             [0.1, -1, 0.1], [0.1, 0.1, 1], [0.1, 0.1, -1]],
            dtype=jnp.float32,
        )
        got = np.asarray(sh.lookup_dir_cm(cm, sh.COS_1, dirs))[:, 0]
        assert np.array_equal(got, [1, 2, 3, 4, 5, 6])

    def test_fresnel_matches_reference_form(self):
        # Monotone-ish sanity + a hand-computed value
        v = float(np.asarray(sh.fresnel_conductor(jnp.float32(1.0), 1.0, 1.1)))
        tmp = (1 + 1.1 * 1.1)
        rp = (tmp - 2 + 1) / (tmp + 2 + 1)
        rs = (tmp - 2 + 1) / (tmp + 2 + 1)
        assert abs(v - (rp + rs) / 2) < 1e-6


class TestPipeline:
    @pytest.fixture(scope="class")
    def cube_scene(self):
        return pp.make_scene(mesh.make_cube(), cubemap.make_procedural_set())

    def test_fill_renders_cube(self, cube_scene):
        eye = camera.cam_orbit(0.5)
        fb = np.asarray(pp.render_frame(
            cube_scene, eye, 0.5, w=W, h=H, per_pixel=True, shader_idx=1,
            backend="xla", show_cm=False))
        bg = np.asarray(pp.background(0, W, H))
        covered = fb != bg
        assert 0.05 < covered.mean() < 0.9

    def test_vertex_vs_pixel_baked_color_identical(self, cube_scene):
        eye = camera.cam_orbit(0.5)
        kw = dict(w=W, h=H, shader_idx=0, backend="xla", show_cm=False)
        a = np.asarray(pp.render_frame(cube_scene, eye, 0.5, per_pixel=False, **kw))
        b = np.asarray(pp.render_frame(cube_scene, eye, 0.5, per_pixel=True, **kw))
        assert np.array_equal(a, b)

    def test_pallas_attr_path_matches_xla(self):
        # The queue path (in-kernel attribute interpolation) must
        # reproduce the oracle's gather-based deferred shading exactly.
        scene = pp.make_scene(mesh.make_sphere(12, 24),
                              cubemap.make_procedural_set())
        eye = camera.cam_orbit(0.7)
        queue = pp.build_scene_queue(scene, eye, W, H)
        for per_pixel in (False, True):
            kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=5,
                      show_cm=False)
            a = np.asarray(pp.render_frame(scene, eye, 0.7, backend="xla", **kw))
            b = np.asarray(pp.render_frame(scene, eye, 0.7, backend="queue",
                                           raster_queue=queue, **kw))
            assert np.array_equal(a, b), f"per_pixel={per_pixel}"

    def test_point_and_line_modes(self, cube_scene):
        eye = camera.cam_orbit(0.5)
        fbp = np.asarray(pp.render_frame(
            cube_scene, eye, 0.5, w=W, h=H, mode=pp.MODE_POINT, shader_idx=0,
            show_cm=False))
        fbl = np.asarray(pp.render_frame(
            cube_scene, eye, 0.5, w=W, h=H, mode=pp.MODE_LINE, shader_idx=0,
            show_cm=False))
        assert (fbp == 0x00FFFFFF).sum() > 0
        assert (fbl == 0x00FFFFFF).sum() > (fbp == 0x00FFFFFF).sum()

    def test_background_gradient(self):
        bg = np.asarray(pp.background(1, 8, 64))
        # Bottom row = start (1.0, 0.4, 0.0): R=255, G=102, B=0
        assert bg[0, 0] == (255 | (102 << 8))
        # Top row = end (0.0, 0.5, 0.5)
        assert bg[-1, 0] == ((127 << 8) | (127 << 16))

    def test_cross_overlay(self, cube_scene):
        eye = camera.cam_orbit(0.5)
        fb_no = np.asarray(pp.render_frame(
            cube_scene, eye, 0.5, w=W, h=H, shader_idx=5, show_cm=False,
            backend="xla"))
        fb_cm = np.asarray(pp.render_frame(
            cube_scene, eye, 0.5, w=W, h=H, shader_idx=5, show_cm=True,
            backend="xla"))
        assert not np.array_equal(fb_no, fb_cm)
        # Overlay pixel inside the cross region
        assert fb_cm[50, 70] == np.asarray(cube_scene.cross)[40, 60]


class TestCameras:
    def test_orbit_radius(self):
        e = camera.cam_orbit(1.0)
        assert abs(np.hypot(e[0], e[2]) - 1.8) < 1e-5
        assert e[1] == 0.0

    def test_all_paths_finite(self):
        for name in camera.CAMERAS:
            for t in (0.0, 0.5, 3.6, 10.0):
                e = camera.camera_eye(name, t)
                assert np.all(np.isfinite(e)), (name, t)

    def test_smootherstep(self):
        assert camera.smootherstep(0, 1, 0.0) == 0.0
        assert camera.smootherstep(0, 1, 1.0) == 1.0
        assert abs(camera.smootherstep(0, 1, 0.5) - 0.5) < 1e-6


def test_benchmark_table_matches_reference():
    from rustexp_tpu.app.benchmark import REF_TOTAL_US, SCENES

    assert sum(s[3] for s in SCENES) == REF_TOTAL_US == 27286
    assert len(SCENES) == 12


class TestQueue:
    """Flat-queue backend (ops/raster_queue.py) vs the XLA oracle."""

    def test_queue_matches_pallas_bit_exact(self):
        # kernel (interpret mode), its XLA twin and the whole-frame oracle
        # agree bit for bit
        scene = pp.make_scene(mesh.make_sphere(8, 16),
                              cubemap.make_procedural_set())
        eye = camera.cam_orbit(0.7)
        queue = pp.build_scene_queue(scene, eye, W, H)
        for ppx in (False, True):
            kw = dict(w=W, h=H, shader_idx=5, show_cm=False, per_pixel=ppx)
            a = np.asarray(pp.render_frame(scene, eye, 0.7,
                                           backend="xla", **kw))
            for backend in ("queue", "queue_xla"):
                b, stale = pp.render_frame(scene, eye, 0.7, backend=backend,
                                           raster_queue=queue,
                                           return_overflow=True, **kw)
                assert not bool(stale)
                assert np.array_equal(a, np.asarray(b)), (backend, ppx)

    def test_queue_stale_on_camera_jump(self):
        scene = pp.make_scene(mesh.make_sphere(8, 16),
                              cubemap.make_procedural_set())
        queue = pp.build_scene_queue(scene, camera.cam_orbit(0.0), W, H)
        # Opposite side of the orbit: tile coverage changes -> stale fires
        _, stale = pp.render_frame(
            scene, camera.cam_orbit(1.8), 1.8, w=W, h=H, shader_idx=0,
            show_cm=False, backend="queue", raster_queue=queue,
            return_overflow=True)
        assert bool(stale)

    def test_moving_amortized_bit_exact(self):
        """Amortized moving-camera structure (dilated AABBs + area margin,
        rebuilt every K frames) renders every frame bit-identically to a
        per-frame rebuild, and the superset certificate (stale flag) holds
        across each chunk."""
        from rustexp_tpu.ops.raster_queue import (build_queue,
                                                  suggest_queue_config,
                                                  queue_stats)
        from rustexp_tpu.ops.raster_setup import (dilate_setup_planar,
                                                  setup_triangles_planar)

        scene = pp.make_scene(mesh.make_sphere(10, 20),
                              cubemap.make_procedural_set())
        K, n = 4, 8
        ticks = [0.9 + i / 60.0 for i in range(n)]
        eyes = [jnp.asarray(camera.cam_orbit(t)) for t in ticks]

        def planar(e):
            xs, ys, zs, _, _, _ = pp.transform_corners_planar(scene, e, W, H)
            return setup_triangles_planar(xs, ys, zs, W, H)

        # generous fixed margins for the test (runtime cert still checks)
        dil = dilate_setup_planar(planar(eyes[0]), 24, W, H, 4096)
        caps = suggest_queue_config(
            tuple(int(x) for x in queue_stats(dil.to_trisetup(), H, W)))
        s_cap, m_y, m_x, t_cap = caps

        for c0 in range(0, n, K):
            dil = dilate_setup_planar(planar(eyes[c0]), 24, W, H, 4096)
            q = build_queue(dil, H, W, s_cap=s_cap, m_y=m_y, m_x=m_x,
                            t_cap=t_cap)
            for i in range(c0, c0 + K):
                kw = dict(w=W, h=H, shader_idx=5, show_cm=False,
                          per_pixel=True, return_overflow=True)
                fb_am, stale = pp.render_frame(
                    scene, eyes[i], ticks[i], backend="queue",
                    raster_queue=q, **kw)
                assert not bool(stale), f"stale fired at frame {i}"
                q_fresh = pp.build_scene_queue(scene, eyes[i], W, H)
                fb_fresh, st2 = pp.render_frame(
                    scene, eyes[i], ticks[i], backend="queue",
                    raster_queue=q_fresh, **kw)
                assert not bool(st2)
                assert np.array_equal(np.asarray(fb_am),
                                      np.asarray(fb_fresh)), f"frame {i}"

    def test_corner_transform_matches_indexed(self):
        scene = pp.make_scene(mesh.make_sphere(8, 16),
                              cubemap.make_procedural_set())
        eye = jnp.asarray(camera.cam_orbit(0.3))
        vp, _, nw = pp.transform_vertices(scene, eye, W, H)
        vp_c, n_c = pp.transform_corners(scene, eye, W, H)
        flat = np.asarray(scene.tris).reshape(-1)
        assert np.array_equal(np.asarray(vp)[flat], np.asarray(vp_c))
        assert np.array_equal(np.asarray(nw)[flat], np.asarray(n_c))


def test_overflow_is_loud():
    # A deliberately tiny slot cap must not drop triangles silently: the
    # stale flag fires, and the suggested caps render the oracle's frame
    # with the flag clear.
    scene = pp.make_scene(mesh.make_sphere(12, 24), cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.7))
    xs, ys, zs, _, _, _ = pp.transform_corners_planar(scene, eye, W, H)
    sp = setup_triangles_planar(xs, ys, zs, W, H)
    small = rq.build_queue(sp, H, W, s_cap=1, m_y=4, m_x=2, t_cap=None)
    kw = dict(w=W, h=H, shader_idx=0, show_cm=False, backend="queue",
              return_overflow=True)
    _, stale_small = pp.render_frame(scene, eye, 0.7, raster_queue=small, **kw)
    assert bool(stale_small)
    fb, stale = pp.render_frame(scene, eye, 0.7, raster_queue=_queue_for(sp),
                                **kw)
    assert not bool(stale)
    fb_plain = pp.render_frame(scene, eye, 0.7, w=W, h=H, shader_idx=0,
                               show_cm=False, backend="xla")
    assert np.array_equal(np.asarray(fb), np.asarray(fb_plain))


def test_bins_compacted_shade_parity():
    """The compacted per-pixel shade over the queue's occupied-block list
    is bit-identical to the full-frame oracle shade, and an undersized
    rows cap raises the stale flag instead of silently dropping covered
    pixels."""
    scene = pp.make_scene(mesh.make_sphere(12, 24), cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.3))
    kw = dict(w=W, h=H, per_pixel=True, shader_idx=5, show_cm=False,
              return_overflow=True)
    full, _ = pp.render_frame(scene, eye, 0.7, backend="xla", **kw)
    xs, ys, zs, _, _, _ = pp.transform_corners_planar(scene, eye, W, H)
    sp = setup_triangles_planar(xs, ys, zs, W, H)
    q = _queue_for(sp)
    comp, stale = pp.render_frame(scene, eye, 0.7, backend="queue",
                                  raster_queue=q, **kw)
    assert not bool(stale)
    assert np.array_equal(np.asarray(full), np.asarray(comp))
    stats = tuple(int(x) for x in rq.queue_stats(sp, H, W))
    s_cap, m_y, m_x, _ = rq.suggest_queue_config(stats)
    tiny = rq.build_queue(sp, H, W, s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=8)
    _, stale_tiny = pp.render_frame(scene, eye, 0.7, backend="queue",
                                    raster_queue=tiny, **kw)
    assert bool(stale_tiny)


def test_suggest_queue_config_quantized():
    """Caps round up to 16 chunks / 64 shade blocks with margin, and the
    span caps get one tile of headroom each way."""
    s_cap, m_y, m_x, t_cap = rq.suggest_queue_config((17, 2, 3, 100))
    assert s_cap % 16 == 0 and s_cap >= 17 * 1.3
    assert t_cap % 64 == 0 and t_cap >= 100 * 1.15
    assert (m_y, m_x) == (3, 4)
    assert rq.suggest_queue_config((0, 1, 1, 0))[::3] == (16, 64)


def test_viewer_headless():
    import sys

    import rustexp_tpu.app.viewer as v

    class FakeTerm:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def poll_key(self):
            return None

    orig_term, orig_write = v._RawTerm, sys.stdout.write
    v._RawTerm = FakeTerm
    sys.stdout.write = lambda s: len(s)
    try:
        n = v.run_viewer(size=64, fps=1000.0, frames=2, start=0)
    finally:
        v._RawTerm, sys.stdout.write = orig_term, orig_write
    assert n == 2


def test_fb_to_ansi():
    import numpy as np

    from rustexp_tpu.app.viewer import fb_to_ansi

    rgb = np.zeros((4, 3, 3), dtype=np.uint8)
    rgb[0, 0] = (255, 0, 0)
    out = fb_to_ansi(rgb)
    assert out.count("▀") == 6  # 3 cols x 2 cell-rows
    assert "38;2;255;0;0" in out


def test_queue_rows_cover_drifted_geometry():
    """Regression (r2 code review): Queue.rows is frozen from build-time
    pair-AABB y-extents; a frame whose geometry drifted WITHIN a tile must
    either still be covered by the rows list (correct pixels) or flip
    `stale` — never render background holes silently."""
    scene = pp.make_scene(mesh.make_sphere(8, 16),
                          cubemap.make_procedural_set())
    base = np.asarray(camera.cam_orbit(0.2), np.float32)
    queue = pp.build_scene_queue(scene, jnp.asarray(base), W, H)
    # a slow orbit sweep: every frame either matches a fresh render exactly
    # or declares itself stale (then a rebuilt queue must match)
    for t in (0.2, 0.205, 0.21, 0.23, 0.3):
        eye = jnp.asarray(camera.cam_orbit(t))
        kw = dict(w=W, h=H, shader_idx=5, show_cm=False, per_pixel=True)
        want = np.asarray(pp.render_frame(scene, eye, t, backend="xla", **kw))
        got, stale = pp.render_frame(scene, eye, t, backend="queue",
                                     raster_queue=queue,
                                     return_overflow=True, **kw)
        if bool(stale):
            queue = pp.build_scene_queue(scene, eye, W, H)
            got, stale = pp.render_frame(scene, eye, t, backend="queue",
                                         raster_queue=queue,
                                         return_overflow=True, **kw)
            assert not bool(stale)
        assert np.array_equal(np.asarray(got), want), f"t={t}"


def test_choose_shade_w():
    """Granularity policy: V configs and zero-x-savings scenes take tile
    width; big savings take the fine width at both thresholds; the
    per-frame-rebuild threshold is strictly more demanding (the finer
    occupancy costs x-extent reductions + a 2x argsort every frame)."""
    from rustexp_tpu.ops.raster_queue import SHADE_W, TILE_W, choose_shade_w

    assert choose_shade_w(10, 100, per_pixel=False) == TILE_W
    # occ_fine == 2*occ_tile: the fine list shades the same pixels
    assert choose_shade_w(200, 100) == TILE_W
    assert choose_shade_w(200, 100, rebuild_per_frame=True) == TILE_W
    # halves the shaded pixels: fine everywhere
    assert choose_shade_w(100, 100) == SHADE_W
    assert choose_shade_w(100, 100, rebuild_per_frame=True) == SHADE_W
    # 14% savings sits between the calibrated thresholds (13.5 / 14.5):
    # fine when the queue is cached, tile when rebuilt per frame
    assert choose_shade_w(172, 100) == SHADE_W
    assert choose_shade_w(172, 100, rebuild_per_frame=True) == TILE_W
    # monotone: any savings level fine under rebuild is fine when cached
    for occ_fine in range(100, 201, 10):
        cached = choose_shade_w(occ_fine, 100)
        moving = choose_shade_w(occ_fine, 100, rebuild_per_frame=True)
        assert not (moving == SHADE_W and cached == TILE_W)


def test_queue_granularity_dual_bit_exact():
    """Queues built at fine and tile shade granularity render bit-equal
    to the XLA oracle; the granularity travels WITH the queue
    (Queue.shade_w is static pytree structure), and the tile_w build's
    xlim is full-range (x drift can't skip shade blocks there)."""
    from rustexp_tpu.ops import raster_queue as rq

    scene = pp.make_scene(mesh.make_sphere(12, 24),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.4))
    kw = dict(w=W, h=H, shader_idx=5, show_cm=False, per_pixel=True)
    want = np.asarray(pp.render_frame(scene, eye, 0.4, backend="xla", **kw))
    for sw in (rq.SHADE_W, rq.TILE_W):
        q = pp.build_scene_queue(scene, eye, W, H, shade_w=sw)
        assert int(q.shade_w) == sw
        if sw == rq.TILE_W:
            xl = np.asarray(q.xlim)
            assert (xl[:, 0] == 0).all() and (xl[:, 1] == W).all()
        got, stale = pp.render_frame(scene, eye, 0.4, backend="queue",
                                     raster_queue=q,
                                     return_overflow=True, **kw)
        assert not bool(stale)
        assert np.array_equal(np.asarray(got), want), f"shade_w={sw}"
    # different granularities are different pytree STRUCTURES
    qa = pp.build_scene_queue(scene, eye, W, H, shade_w=rq.SHADE_W)
    qb = pp.build_scene_queue(scene, eye, W, H, shade_w=rq.TILE_W)
    sa = jax.tree_util.tree_structure(qa)
    sb = jax.tree_util.tree_structure(qb)
    assert sa != sb


@pytest.mark.parametrize("per_pixel", [True, False])
def test_queue_kernel_matches_xla_twin(per_pixel):
    """The Pallas kernel (interpret mode) and its plain-XLA twin produce
    the same frame bit for bit through raster_and_shade_queue — the twin
    is the kernel's timing baseline and its CPU stand-in."""
    scene = pp.make_scene(mesh.make_sphere(10, 20),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.7))
    w = h = 128
    queue = pp.build_scene_queue(scene, eye, w, h)
    colors = None
    if not per_pixel:
        _, world, n_world = pp.transform_vertices(scene, eye, w, h)
        colors = pp.sh.shader_fn(5)(world, n_world, scene.colors, eye,
                                    jnp.float32(0.7), scene.cm)
    bg = pp.background(0, w, h)
    outs = [pp.raster_and_shade_queue(scene, queue, colors, eye,
                                      jnp.float32(0.7), w=w, h=h,
                                      per_pixel=per_pixel, shader_idx=5,
                                      bg_fb=bg, impl=impl)[0]
            for impl in ("kernel", "xla")]
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))


def _planar_setup_and_extra(scene, eye, w, h):
    from rustexp_tpu.ops.raster_setup import setup_triangles_planar

    xs, ys, zs, iw, _, _ = pp.transform_corners_planar(scene, eye, w, h)
    setup = setup_triangles_planar(xs, ys, zs, w, h)
    T = scene.tris.shape[0]
    one = jnp.ones((T,), jnp.float32)
    extra = (one * iw[0], one * iw[1] - one * iw[0], one * iw[2] - one * iw[0])
    return setup, extra


def _masked_eq(z1, m1, z2, m2):
    return np.array_equal(m1, m2) and np.array_equal(z1[m1], z2[m1])


def test_queue_plane_order_bit_exact():
    """The round-5 plane-ordered build (one small sort + run
    reconstruction, order="plane") must rasterize bit-identically to the
    legacy tile-segment order — the kernels' (z, tri) lexicographic
    tie-break makes the winner independent of slot presentation order
    (the order-free form of rasterizer.rs:1704-1708 first-wins ties)."""
    from rustexp_tpu.ops import raster_queue as rq

    scene = pp.make_scene(mesh.make_sphere(16, 32),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.7))
    setup, extra = _planar_setup_and_extra(scene, eye, W, H)
    stats = tuple(int(x) for x in rq.queue_stats(setup, H, W))
    s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
    res = {}
    for order in ("tri", "plane"):
        q = rq.build_queue(setup, H, W, s_cap=s_cap, m_y=m_y, m_x=m_x,
                           t_cap=t_cap, order=order)
        assert not bool(q.overflow)
        z, mask, lin, _ = rq.raster_attrs_queue(q, setup, extra, 1, 0, H, W)
        res[order] = (np.asarray(z), np.asarray(mask),
                      np.asarray(lin[0]), _tile_sets(q))
    # same per-tile pair multisets
    assert res["tri"][3] == res["plane"][3]
    zt, mt, lt, _ = res["tri"]
    zp, mp, lp, _ = res["plane"]
    assert _masked_eq(zp, mp, zt, mt)
    assert np.array_equal(lp[mt], lt[mt])


def test_queue_direct_order_identical_to_tri():
    """The tiny-mesh "direct" build (counts + slot ids straight off the
    coverage matrix, no sort/gather) must produce a Queue IDENTICAL to
    the legacy "tri" pair-key-sort layout, leaf for leaf — same ascending
    triangle order per tile, same chunk scalars, same rows list — both
    whole-frame and under a cyclic row interleave."""
    from rustexp_tpu.ops import raster_queue as rq

    sph = mesh.make_sphere(4, 8)
    assert sph.num_tris <= 64, "test mesh must hit the direct-order regime"
    # Second config: a 1024-triangle sphere rendered onto a 128x128 frame
    # in 16-row tiles (8 tiles) so per-tile counts exceed one chunk —
    # exercises the k_of > 0 rank-match path that the tiny mesh never
    # reaches.
    dense = mesh.make_sphere(16, 32)
    cases = [(sph, W, H, rq.TILE_H), (dense, 128, 128, 16)]
    saw_multichunk = False
    for msh, w_, h_, th in cases:
        scene = pp.make_scene(msh, cubemap.make_procedural_set())
        eye = jnp.asarray(camera.cam_orbit(0.7))
        setup, _ = _planar_setup_and_extra(scene, eye, w_, h_)
        stats = tuple(int(x) for x in rq.queue_stats(setup, h_, w_,
                                                     tile_h=th))
        s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
        for kw in ({"tile_h": th},
                   {"tile_h": th, "row_stride": 2, "row_offset": 1}):
            qt = rq.build_queue(setup, h_, w_, s_cap=s_cap, m_y=m_y,
                                m_x=m_x, t_cap=t_cap, order="tri", **kw)
            qd = rq.build_queue(setup, h_, w_, s_cap=s_cap, m_y=m_y,
                                m_x=m_x, t_cap=t_cap, order="direct", **kw)
            assert not bool(qt.overflow) and not bool(qd.overflow)
            saw_multichunk |= bool(
                (np.asarray(qt.tiles)[:, 1] > rq.CHUNK).any())
            lt = jax.tree_util.tree_leaves(qt)
            ld = jax.tree_util.tree_leaves(qd)
            assert len(lt) == len(ld)
            for a, b in zip(lt, ld):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert saw_multichunk, "no tile needed >1 chunk; dense case too sparse"


@pytest.mark.parametrize("D", [2, 4, 8])
def test_queue_cyclic_interleave_bit_exact(D):
    """Cyclic tile-row interleaved band queues (row_stride=D) rasterize
    each band bit-identically to the corresponding global rows of a
    whole-frame render, for both slot orders — the sharded rasterizer's
    load-balance layout (VERDICT r4 #3; reference's analog is its
    sort-tiles-by-bin-size schedule, rasterizer.rs:2165-2167)."""
    from rustexp_tpu.ops import raster_queue as rq

    tile_h = rq.TILE_H
    scene = pp.make_scene(mesh.make_sphere(16, 32),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.7))
    setup, extra = _planar_setup_and_extra(scene, eye, W, H)

    stats = tuple(int(x) for x in rq.queue_stats(setup, H, W))
    caps = rq.suggest_queue_config(stats)
    qf = rq.build_queue(setup, H, W, s_cap=caps[0], m_y=caps[1],
                        m_x=caps[2], t_cap=caps[3], order="tri")
    zf, mf, _, _ = rq.raster_attrs_queue(qf, setup, extra, 1, 0, H, W)
    zf, mf = np.asarray(zf), np.asarray(mf)

    sts = [tuple(int(x) for x in rq.queue_stats(
        setup, H, W, row_stride=D, row_offset=d)) for d in range(D)]
    agg = tuple(max(s[j] for s in sts) for j in range(4))
    s_c, my, mx, t_c = rq.suggest_queue_config(agg)
    bh = H // D
    zb = np.zeros((H, W), np.float32)
    mb = np.zeros((H, W), bool)
    for d in range(D):
        zd = md = None
        for order in ("tri", "plane"):
            q = rq.build_queue(setup, H, W, s_cap=s_c, m_y=my, m_x=mx,
                               t_cap=t_c, order=order, row_stride=D,
                               row_offset=d)
            assert not bool(q.overflow)
            z, m_, _, stale = rq.raster_attrs_queue(
                q, setup, extra, 1, 0, bh, W)
            assert not bool(stale)
            z, m_ = np.asarray(z), np.asarray(m_)
            if order == "tri":
                zd, md = z, m_
            else:
                assert _masked_eq(z, m_, zd, md), f"D={D} d={d}"
        for lt in range(bh // tile_h):
            g = lt * D + d
            zb[g * tile_h:(g + 1) * tile_h] = zd[lt * tile_h:(lt + 1) * tile_h]
            mb[g * tile_h:(g + 1) * tile_h] = md[lt * tile_h:(lt + 1) * tile_h]
    assert _masked_eq(zb, mb, zf, mf)
