"""Multi-device (8 virtual CPU devices) semantics tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from rustexp_tpu.ops import gol_stencil
from rustexp_tpu.parallel import gol_shard


def _mesh(n=8, axis="rows"):
    return Mesh(np.array(jax.devices()[:n]), axis_names=(axis,))


def test_gol_sharded_matches_single_device():
    rng = np.random.default_rng(42)
    g = jnp.asarray(rng.integers(0, 2, (256, 256)).astype(np.int32))
    mesh = _mesh(8)
    step8 = gol_shard.make_multi_step(mesh, k=8)
    got = step8(gol_shard.shard_grid(g, mesh))
    want = gol_stencil.multi_step(g, 8, "roll")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gol_sharded_various_device_counts():
    rng = np.random.default_rng(7)
    g = jnp.asarray(rng.integers(0, 2, (64, 64)).astype(np.int32))
    want = np.asarray(gol_stencil.multi_step(g, 3, "roll"))
    for n in (2, 4):
        mesh = _mesh(n)
        step = gol_shard.make_multi_step(mesh, k=3)
        got = np.asarray(step(gol_shard.shard_grid(g, mesh)))
        np.testing.assert_array_equal(got, want)


def test_nbody_sharded_matches_single_device():
    import jax.numpy as jnp
    from rustexp_tpu.ops import nbody_forces
    from rustexp_tpu.parallel import nbody_shard

    rng = np.random.default_rng(5)
    n = 512
    px = jnp.asarray(rng.uniform(-30, 30, n), jnp.float32)
    py = jnp.asarray(rng.uniform(-30, 30, n), jnp.float32)
    vx = jnp.asarray(rng.uniform(-1, 1, n), jnp.float32)
    vy = jnp.asarray(rng.uniform(-1, 1, n), jnp.float32)
    m = jnp.asarray(rng.uniform(0.1, 1.5, n), jnp.float32)

    want = nbody_forces.step_brute_force(px, py, vx, vy, m, 0, 0.01)

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("p",))
    step = nbody_shard.make_step(mesh)
    got = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh),
               jnp.float32(0.01))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=2e-4, atol=2e-4)

    # dt is traced: a different dt must NOT recompile (interactive X/x keys)
    n_compiles = step._cache_size() if hasattr(step, "_cache_size") else None
    got2 = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh),
                jnp.float32(0.02))
    want2 = nbody_forces.step_brute_force(px, py, vx, vy, m, 0, 0.02)
    np.testing.assert_allclose(np.asarray(got2[0]), np.asarray(want2[0]),
                               rtol=2e-4, atol=2e-4)
    if n_compiles is not None:
        assert step._cache_size() == n_compiles


def test_raster_sharded_matches_single_device():
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    w, h = 128, 128
    scene = pp.make_scene(mesh_assets.make_cube(), cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.5))
    want = np.asarray(pp.render_frame(
        scene, eye, 0.5, w=w, h=h, per_pixel=True, shader_idx=2,
        backend="xla", show_cm=False))
    for n in (2, 4, 8):
        dmesh = _mesh(n)
        got = np.asarray(raster_shard.render_frame_sharded(
            scene, eye, 0.5, dmesh, w=w, h=h, per_pixel=True, shader_idx=2))
        # The integer snap/edge math commutes exactly with the band
        # translation, but XLA compiles the band-shaped program with
        # different fma fusion than the full-frame one (host-dependent),
        # so interpolated z can differ in the last bit — and at shared
        # mesh edges, where two triangles tie within an ulp, the depth
        # winner can flip (observed: up to 22/16384 pixels after a
        # terminal re-provision changed the host CPU; previously 0).
        # The contract is therefore: identical except for a sub-0.5%
        # sprinkle of shared-edge winner flips.
        diff = got != want
        assert diff.mean() < 5e-3, f"n={n}: {diff.sum()} pixels differ"


def test_raster_sharded_per_vertex():
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    w, h = 128, 64
    scene = pp.make_scene(mesh_assets.make_sphere(8, 16),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(1.2))
    want = np.asarray(pp.render_frame(
        scene, eye, 1.2, w=w, h=h, per_pixel=False, shader_idx=5,
        backend="xla", show_cm=False))
    dmesh = _mesh(4)
    got = np.asarray(raster_shard.render_frame_sharded(
        scene, eye, 1.2, dmesh, w=w, h=h, per_pixel=False, shader_idx=5))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 2-D meshes: the long dimension sharded over BOTH axes. JAX treats the
# axis tuple as one combined ring; the programs must be bit-exact there
# too.
# ---------------------------------------------------------------------------


def _mesh2(dcn=2, ici=4):
    return Mesh(np.array(jax.devices()[:dcn * ici]).reshape(dcn, ici),
                axis_names=("dcn", "ici"))


def test_gol_sharded_multihost_mesh():
    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.integers(0, 2, (64, 64)).astype(np.int32))
    want = np.asarray(gol_stencil.multi_step(g, 4, "roll"))
    mesh = _mesh2()
    step = gol_shard.make_multi_step(mesh, axis=("dcn", "ici"), k=4)
    got = np.asarray(step(gol_shard.shard_grid(g, mesh, axis=("dcn", "ici"))))
    np.testing.assert_array_equal(got, want)


def test_nbody_sharded_multihost_mesh():
    from rustexp_tpu.ops import nbody_forces
    from rustexp_tpu.parallel import nbody_shard

    rng = np.random.default_rng(6)
    n = 256
    px = jnp.asarray(rng.uniform(-30, 30, n), jnp.float32)
    py = jnp.asarray(rng.uniform(-30, 30, n), jnp.float32)
    vx = jnp.asarray(rng.uniform(-1, 1, n), jnp.float32)
    vy = jnp.asarray(rng.uniform(-1, 1, n), jnp.float32)
    m = jnp.asarray(rng.uniform(0.1, 1.5, n), jnp.float32)
    want = nbody_forces.step_brute_force(px, py, vx, vy, m, 0, 0.01)
    mesh = _mesh2()
    step = nbody_shard.make_step(mesh, axis=("dcn", "ici"))
    got = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh,
                                            axis=("dcn", "ici")),
               jnp.float32(0.01))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)


def test_raster_sharded_multihost_mesh():
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    scene = pp.make_scene(mesh_assets.make_sphere(6, 12),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.4))
    want = np.asarray(pp.render_frame(scene, eye, 0.4, w=64, h=64,
                                      shader_idx=5, show_cm=False,
                                      backend="xla"))
    mesh2 = _mesh2()
    render = raster_shard.make_sharded_render(
        mesh2, w=64, h=64, shader_idx=5, axis=("dcn", "ici"))
    got = np.asarray(render(scene, eye, jnp.float32(0.4)))
    np.testing.assert_array_equal(got, want)


def test_gol_sharded_unknown_backend_raises():
    import pytest

    with pytest.raises(ValueError, match="backend"):
        gol_shard.make_multi_step(_mesh(2), k=2, backend="swar")


def test_gol_sharded_pallas_single_device_mesh():
    # Regression: a dead `k > r*(n_dev-1)` guard rejected every k >= 1
    # on a 1-device mesh, though the self-ppermute halo is exact there.
    g = jnp.asarray(np.random.default_rng(3).integers(
        0, 2, (64, 128)).astype(np.int32))
    ref = np.asarray(gol_stencil.multi_step(g, 4, "roll"))
    step = gol_shard.make_multi_step(_mesh(1), k=4, backend="bits")
    got = np.asarray(step(gol_shard.shard_grid(g, _mesh(1))))
    np.testing.assert_array_equal(got, ref)


def test_gol_sharded_pallas_backend_matches_oracle():
    """The sharded GoL runs the PRODUCTION SWAR step. k-deep halos absorb
    k generations of y-torus contamination, so the interior is bit-exact
    vs the single-device evolution."""
    rng = np.random.default_rng(42)
    g = jnp.asarray(rng.integers(0, 2, (256, 256)).astype(np.int32))
    mesh = _mesh(8)
    for k in (1, 8, 32):
        step = gol_shard.make_multi_step(mesh, k=k, backend="bits")
        got = np.asarray(step(gol_shard.shard_grid(g, mesh)))
        want = np.asarray(gol_stencil.multi_step(g, k, "roll"))
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


def test_gol_sharded_bits_backend_matches_oracle():
    """The sharded GoL over the SWAR bit-packed kernel (the fastest
    single-chip path, ops/gol_bits.py) is bit-exact vs the roll oracle:
    the halo (rounded up to 16 rows for word alignment) absorbs the
    padded-edge torus contamination, including halos that round up."""
    rng = np.random.default_rng(43)
    g = jnp.asarray(rng.integers(0, 2, (256, 256)).astype(np.int32))
    mesh = _mesh(8)  # 32 rows/shard: halo<=32 caps k at 32
    for k in (1, 8, 17, 32):
        step = gol_shard.make_multi_step(mesh, k=k, backend="bits")
        got = np.asarray(step(gol_shard.shard_grid(g, mesh)))
        want = np.asarray(gol_stencil.multi_step(g, k, "roll"))
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


def test_gol_sharded_bits_past_single_chip_ceiling():
    """8 shards of a 4096^2 grid each pack a 512(+32)-row band: a grid
    larger than any one device's share steps bit-exactly through the
    halo-padded local SWAR step."""
    rng = np.random.default_rng(44)
    g = jnp.asarray(rng.integers(0, 2, (4096, 4096)).astype(np.int32))
    mesh = _mesh(8)
    step = gol_shard.make_multi_step(mesh, k=2, backend="bits")
    got = np.asarray(step(gol_shard.shard_grid(g, mesh)))
    want = np.asarray(gol_stencil.multi_step(g, 2, "roll"))
    np.testing.assert_array_equal(got, want)


def test_gol_sharded_bits_bands_within_shard():
    """Tall shards (256 rows each) with halos of one and two bit-words:
    the padded local block (288 / 320 rows) steps as its own torus, and
    its wrong wrap never reaches the interior, so the result must match
    the roll oracle."""
    rng = np.random.default_rng(45)
    g = jnp.asarray(rng.integers(0, 2, (2048, 256)).astype(np.int32))
    mesh = _mesh(8)  # 256 rows/shard; padded = 288 (k=8) / 320 (k=32) rows
    for k in (8, 32):
        step = gol_shard.make_multi_step(mesh, k=k, backend="bits")
        got = np.asarray(step(gol_shard.shard_grid(g, mesh)))
        want = np.asarray(gol_stencil.multi_step(g, k, "roll"))
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


def test_nbody_sharded_block_bh_matches_single_device():
    """VERDICT r2 #3b: the sharded N-body must cover the production block
    Barnes-Hut path, not just brute force. The local-target-slice
    decomposition reproduces single-device step_bh bit-for-bit."""
    from rustexp_tpu.ops import nbody_bh
    from rustexp_tpu.parallel import nbody_shard
    from rustexp_tpu.sims.nbody import stable_orbits

    px, py, vx, vy, m = stable_orbits(jax.random.PRNGKey(0), 4096)
    want = nbody_bh.step_bh(px, py, vx, vy, m, 128, 6, 0.01)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("p",))
    step = nbody_shard.make_step_bh(mesh, block=128, k_near=6)
    got = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh),
               jnp.float32(0.01))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # dt is traced: different dt, same compiled fn
    got2 = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh),
                jnp.float32(0.02))
    want2 = nbody_bh.step_bh(px, py, vx, vy, m, 128, 6, 0.02)
    np.testing.assert_array_equal(np.asarray(got2[0]), np.asarray(want2[0]))


def test_raster_sharded_queue_backend_bit_exact():
    """VERDICT r2 #3a: the sharded raster must cover the PRODUCTION
    flat-queue path. With the post-snap integer band translation
    (trunc-to-zero does not commute with float-side translation across
    zero — a real 1-px band-boundary bug this test caught), every band is
    bit-identical to the corresponding rows of the single-device render."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    w = h = 128
    scene = pp.make_scene(mesh_assets.make_sphere(12, 24),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.5))
    queue1 = pp.build_scene_queue(scene, eye, w, h)
    for per_pixel in (True, False):
        colors = None
        if not per_pixel:
            _, world, n_world = pp.transform_vertices(scene, eye, w, h)
            colors = pp.sh.shader_fn(5)(world, n_world, scene.colors, eye,
                                        jnp.float32(0.5), scene.cm)
        bg = pp.background(0, w, h)
        want, _ = pp.raster_and_shade_queue(
            scene, queue1, colors, eye, jnp.float32(0.5), w=w, h=h,
            per_pixel=per_pixel, shader_idx=5, bg_fb=bg)
        mesh = _mesh(4)
        queues = raster_shard.build_band_queues(scene, eye, w=w, h=h, n_dev=4)
        queues = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P("rows"))),
            queues)
        render = raster_shard.make_sharded_queue_render(
            mesh, scene, eye, w=w, h=h, per_pixel=per_pixel, shader_idx=5)
        got, stale = render(scene, queues, eye, jnp.float32(0.5))
        assert not bool(stale)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"per_pixel={per_pixel}")


def test_raster_sharded_moving_rebuild_bit_exact():
    """The sharded MOVING-CAMERA path: each device rebuilds its band's
    queue in-graph every frame (zero host trips). At several eyes along
    the orbit, output must be bit-identical to the single-device queue
    render, and the stale flag must stay False inside the sampled caps."""
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    w = h = 128
    scene = pp.make_scene(mesh_assets.make_sphere(12, 24),
                          cubemap.make_procedural_set())
    ticks = [0.0, 0.37, 0.81]
    eyes = [jnp.asarray(camera.cam_orbit(t)) for t in ticks]
    mesh = _mesh(4)
    render = raster_shard.make_sharded_queue_render_moving(
        mesh, scene, eyes, w=w, h=h, per_pixel=True, shader_idx=5)
    for t, eye in zip(ticks, eyes):
        queue1 = pp.build_scene_queue(scene, eye, w, h)
        bg = pp.background(0, w, h)
        want, _ = pp.raster_and_shade_queue(
            scene, queue1, None, eye, jnp.float32(t), w=w, h=h,
            per_pixel=True, shader_idx=5, bg_fb=bg)
        got, stale = render(scene, eye, jnp.float32(t))
        assert not bool(stale), f"caps went stale at tick {t}"
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"tick={t}")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_raster_sharded_cyclic_interleave_bit_exact(n_dev):
    """layout="cyclic" (VERDICT r4 #3): each device owns every n_dev-th
    TILE ROW instead of a contiguous band — bounded load imbalance on
    center-heavy meshes. After deinterleave_rows, both the cached-queue
    and the per-frame in-graph rebuild paths must be bit-identical to the
    single-device queue render."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.ops.raster_queue import TILE_H
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    w = h = 128
    scene = pp.make_scene(mesh_assets.make_sphere(12, 24),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.5))
    queue1 = pp.build_scene_queue(scene, eye, w, h)
    bg = pp.background(0, w, h)
    want, _ = pp.raster_and_shade_queue(
        scene, queue1, None, eye, jnp.float32(0.5), w=w, h=h,
        per_pixel=True, shader_idx=5, bg_fb=bg)
    want = np.asarray(want)

    mesh = _mesh(n_dev)
    queues = raster_shard.build_band_queues(scene, eye, w=w, h=h,
                                            n_dev=n_dev, layout="cyclic")
    queues = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("rows"))), queues)
    render = raster_shard.make_sharded_queue_render(
        mesh, scene, eye, w=w, h=h, per_pixel=True, shader_idx=5,
        layout="cyclic")
    got, stale = render(scene, queues, eye, jnp.float32(0.5))
    assert not bool(stale)
    got = np.asarray(raster_shard.deinterleave_rows(got, n_dev, TILE_H))
    np.testing.assert_array_equal(got, want)

    # moving path: in-graph cyclic rebuild at several eyes
    ticks = [0.0, 0.37]
    eyes = [jnp.asarray(camera.cam_orbit(t)) for t in ticks]
    mrender = raster_shard.make_sharded_queue_render_moving(
        mesh, scene, eyes, w=w, h=h, per_pixel=True, shader_idx=5,
        layout="cyclic")
    for t, e in zip(ticks, eyes):
        q1 = pp.build_scene_queue(scene, e, w, h)
        wantm, _ = pp.raster_and_shade_queue(
            scene, q1, None, e, jnp.float32(t), w=w, h=h,
            per_pixel=True, shader_idx=5, bg_fb=bg)
        gotm, stalem = mrender(scene, e, jnp.float32(t))
        assert not bool(stalem), f"caps went stale at tick {t}"
        gotm = np.asarray(raster_shard.deinterleave_rows(gotm, n_dev, TILE_H))
        np.testing.assert_array_equal(gotm, np.asarray(wantm),
                                      err_msg=f"tick={t}")


def test_production_paths_multihost_mesh():
    """The production sharded steps (SWAR GoL, block-BH) also run over a
    2-D mesh with the long axis sharded over BOTH axes (collectives over
    an axis tuple). Bit-exact."""
    from rustexp_tpu.ops import nbody_bh
    from rustexp_tpu.parallel import nbody_shard
    from rustexp_tpu.sims.nbody import stable_orbits

    mesh2 = _mesh2()
    ax = ("dcn", "ici")

    rng = np.random.default_rng(1)
    g = jnp.asarray(rng.integers(0, 2, (256, 256)).astype(np.int32))
    step = gol_shard.make_multi_step(mesh2, axis=ax, k=8, backend="bits")
    got = np.asarray(step(gol_shard.shard_grid(g, mesh2, axis=ax)))
    want = np.asarray(gol_stencil.multi_step(g, 8, "roll"))
    np.testing.assert_array_equal(got, want)

    px, py, vx, vy, m = stable_orbits(jax.random.PRNGKey(0), 4096)
    want = nbody_bh.step_bh(px, py, vx, vy, m, 128, 6, 0.01)
    step = nbody_shard.make_step_bh(mesh2, axis=ax, block=128, k_near=6)
    got = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh2,
                                            axis=ax), jnp.float32(0.01))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # SWAR bit-packed GoL with a different grid shape over the same mesh
    g = jnp.asarray(rng.integers(0, 2, (256, 128)).astype(np.int32))
    bstep = gol_shard.make_multi_step(mesh2, axis=ax, k=4, backend="bits")
    bgot = np.asarray(bstep(gol_shard.shard_grid(g, mesh2, axis=ax)))
    np.testing.assert_array_equal(
        bgot, np.asarray(gol_stencil.multi_step(g, 4, "roll")))


def test_raster_queue_multihost_mesh():
    """The PRODUCTION flat-queue renderers (cached bands + per-frame
    in-graph rebuild) over a 2-D ("dcn", "ici") mesh — bit-exact."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rustexp_tpu.assets import cubemap, mesh as mesh_assets
    from rustexp_tpu.parallel import raster_shard
    from rustexp_tpu.raster import camera, pipeline as pp

    w = h = 128
    ax = ("dcn", "ici")
    mesh2 = _mesh2()
    scene = pp.make_scene(mesh_assets.make_sphere(12, 24),
                          cubemap.make_procedural_set())
    eye = jnp.asarray(camera.cam_orbit(0.5))
    queue1 = pp.build_scene_queue(scene, eye, w, h)
    bg = pp.background(0, w, h)
    want, _ = pp.raster_and_shade_queue(
        scene, queue1, None, eye, jnp.float32(0.5), w=w, h=h,
        per_pixel=True, shader_idx=5, bg_fb=bg)

    queues = raster_shard.build_band_queues(scene, eye, w=w, h=h, n_dev=8)
    queues = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh2, P(ax))), queues)
    render = raster_shard.make_sharded_queue_render(
        mesh2, scene, eye, w=w, h=h, per_pixel=True, shader_idx=5, axis=ax)
    got, stale = render(scene, queues, eye, jnp.float32(0.5))
    assert not bool(stale)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    mrender = raster_shard.make_sharded_queue_render_moving(
        mesh2, scene, [eye], w=w, h=h, per_pixel=True, shader_idx=5, axis=ax)
    got2, stale2 = mrender(scene, eye, jnp.float32(0.5))
    assert not bool(stale2)
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(want))


def test_gol_sharded_pallas_big_grid():
    """2048^2 row-sharded over 8 devices through the SWAR step with
    k-halo-padded local blocks — bit-exact vs the roll oracle."""
    rng = np.random.default_rng(9)
    g = jnp.asarray(rng.integers(0, 2, (2048, 2048)).astype(np.int32))
    mesh = _mesh(8)
    step = gol_shard.make_multi_step(mesh, k=4, backend="bits")
    got = np.asarray(step(gol_shard.shard_grid(g, mesh)))
    want = np.asarray(gol_stencil.multi_step(g, 4, "roll"))
    np.testing.assert_array_equal(got, want)


def test_dist_sort_stable_bit_exact():
    """parallel/sort_shard: the hypercube compare-split sort's
    concatenated output must be BIT-IDENTICAL to a replicated stable
    sort — including heavy key ties, which the (key, global position)
    lexicographic compare resolves exactly like jnp's stable argsort."""
    from functools import partial

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from rustexp_tpu.parallel.sort_shard import dist_sort_stable

    mesh = _mesh(8, "p")
    n = 8 * 2048
    rng = np.random.default_rng(0)
    key = rng.integers(0, 50, n).astype(np.int32)  # ~330 ties per key
    vals = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]

    @partial(shard_map, mesh=mesh, in_specs=(P("p"),) * 4,
             out_specs=(P("p"),) * 5, check_rep=False)
    def run(k, a, b, c):
        sk, sg, sv = dist_sort_stable(k, [a, b, c], "p", 8)
        return (sk, sg, *sv)

    sk, sg, *sv = run(jnp.asarray(key), *[jnp.asarray(v) for v in vals])
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), key[order])
    np.testing.assert_array_equal(np.asarray(sg), order)
    for got, v in zip(sv, vals):
        np.testing.assert_array_equal(np.asarray(got), v[order])


def test_dist_sort_xla_fallback_matches():
    """Non-power-of-two local chunks sort and merge exactly as well —
    same global result as a replicated stable sort."""
    from functools import partial

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from rustexp_tpu.parallel.sort_shard import dist_sort_stable

    mesh = _mesh(8, "p")
    n = 8 * 384  # 384 is not a power of two
    rng = np.random.default_rng(1)
    key = rng.integers(0, 9, n).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)

    @partial(shard_map, mesh=mesh, in_specs=(P("p"),) * 2,
             out_specs=(P("p"),) * 3, check_rep=False)
    def run(k, a):
        sk, sg, sv = dist_sort_stable(k, [a], "p", 8)
        return (sk, sg, sv[0])

    sk, sg, sval = run(jnp.asarray(key), jnp.asarray(val))
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), key[order])
    # gidx must be the stable argsort order itself (a gidx bug would
    # otherwise pass on keys/values alone)
    np.testing.assert_array_equal(np.asarray(sg), order)
    np.testing.assert_array_equal(np.asarray(sval), val[order])


def test_nbody_sharded_bh_distributed_vs_replicated_sort():
    """make_step_bh's distributed-sort path (the round-4 Amdahl fix: the
    Morton sort previously ran replicated on every device) must equal
    both the replicated-sort oracle form and single-device step_bh,
    across multiple steps."""
    from rustexp_tpu.ops import nbody_bh
    from rustexp_tpu.parallel import nbody_shard
    from rustexp_tpu.sims.nbody import stable_orbits

    px, py, vx, vy, m = stable_orbits(jax.random.PRNGKey(2), 4096)
    mesh = _mesh(8, "p")
    step_d = nbody_shard.make_step_bh(mesh, block=128, k_near=6,
                                      distributed_sort=True)
    step_r = nbody_shard.make_step_bh(mesh, block=128, k_near=6,
                                      distributed_sort=False)
    sd = nbody_shard.shard_particles((px, py, vx, vy, m), mesh)
    sr = sd
    ref = (px, py, vx, vy, m)
    for _ in range(3):
        sd = step_d(*sd, jnp.float32(0.01))
        sr = step_r(*sr, jnp.float32(0.01))
        ref = nbody_bh.step_bh(*ref, 128, 6, 0.01)
        for g, w in zip(sd, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        for g, w in zip(sr, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("n_dev", [3, 6])
def test_dist_sort_non_power_of_two_devices(n_dev):
    """Non-power-of-two D runs the odd-even transposition schedule
    (round-5 #4c — previously a silent replicated-sort fallback). The
    concatenated output must still be bit-identical to a replicated
    stable sort, including heavy ties."""
    from functools import partial

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from rustexp_tpu.parallel.sort_shard import dist_sort_stable

    mesh = _mesh(n_dev, "p")
    n = n_dev * 512
    rng = np.random.default_rng(4)
    key = rng.integers(0, 40, n).astype(np.int32)
    vals = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]

    @partial(shard_map, mesh=mesh, in_specs=(P("p"),) * 3,
             out_specs=(P("p"),) * 4, check_rep=False)
    def run(k, a, b):
        sk, sg, sv = dist_sort_stable(k, [a, b], "p", n_dev)
        return (sk, sg, *sv)

    sk, sg, *sv = run(jnp.asarray(key), *[jnp.asarray(v) for v in vals])
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), key[order])
    np.testing.assert_array_equal(np.asarray(sg), order)
    for got, v in zip(sv, vals):
        np.testing.assert_array_equal(np.asarray(got), v[order])


def test_nbody_sharded_bh_non_power_of_two_devices():
    """The sharded BH step at D=6 (non-po2: odd-even-transposition
    distributed sort + sharded aggregates/ranking) must still match
    single-device step_bh bit-for-bit."""
    from rustexp_tpu.ops import nbody_bh
    from rustexp_tpu.parallel import nbody_shard
    from rustexp_tpu.sims.nbody import stable_orbits

    px, py, vx, vy, m = stable_orbits(jax.random.PRNGKey(3), 6 * 512)
    mesh = _mesh(6, "p")
    step = nbody_shard.make_step_bh(mesh, block=128, k_near=6)
    got = step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh),
               jnp.float32(0.01))
    want = nbody_bh.step_bh(px, py, vx, vy, m, 128, 6, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_nbody_sharded_bh_bad_blocking_raises():
    """VERDICT r4 #4a: indivisible block/device configs must raise a
    clear Python error at trace time, not fail device-side."""
    from rustexp_tpu.parallel import nbody_shard
    from rustexp_tpu.sims.nbody import stable_orbits

    px, py, vx, vy, m = stable_orbits(jax.random.PRNGKey(4), 1024)
    mesh = _mesh(8, "p")
    # N=1024, block=256 -> B=4 < 8 devices
    step = nbody_shard.make_step_bh(mesh, block=256, k_near=2)
    with pytest.raises(ValueError, match="multiple of n_dev"):
        step(*nbody_shard.shard_particles((px, py, vx, vy, m), mesh),
             jnp.float32(0.01))
