"""The platform decision, the compile cache, matmul precision, and the
kernels' GPU lowering — what moving the system onto the GPU rests on."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from rustexp_tpu.core import platform as plat


@pytest.mark.parametrize("platform,mode", [("gpu", "compiled"),
                                           ("cuda", "compiled"),
                                           ("cpu", "interpret")])
def test_kernel_mode(platform, mode):
    assert plat.kernel_mode(platform) == mode
    assert plat.use_interpret(None, platform) == (mode == "interpret")


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_kernel_mode_other_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no kernel path"):
        plat.kernel_mode(platform)


def test_kernel_mode_default_and_explicit_interpret():
    # the test process runs on the CPU; an explicit flag always wins
    assert plat.kernel_mode() == "interpret"
    assert plat.use_interpret(False, "cpu") is False
    assert plat.use_interpret(True, "gpu") is True


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = plat.compile_cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d.startswith(os.path.join(repo, ".jax_cache") + os.sep)
    assert d == plat.compile_cache_dir()  # same path every call


@pytest.mark.parametrize("env,want", [("0", False), ("1", True),
                                      (None, True)])
def test_strict_ieee_default(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("RUSTEXP_STRICT_IEEE", raising=False)
    else:
        monkeypatch.setenv("RUSTEXP_STRICT_IEEE", env)
    assert plat.strict_ieee_default() is want


# ---------------------------------------------------------------- precision

def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "eqns"):
                    yield from _dot_generals(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    yield from _dot_generals(sub.jaxpr)


def _assert_f32_dots_highest(closed):
    dots = [e for e in _dot_generals(closed.jaxpr)
            if any(v.aval.dtype == jnp.float32 for v in e.invars)]
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == lax.Precision.HIGHEST for p in prec), prec
    return len(dots)


def _sphere_setup():
    from rustexp_tpu.assets import cubemap, mesh
    from rustexp_tpu.ops.raster_setup import setup_triangles_planar
    from rustexp_tpu.raster import camera, pipeline as pp

    scene = pp.make_scene(mesh.make_sphere(8, 16),
                          cubemap.make_procedural_set())
    xs, ys, zs, _, _, _ = pp.transform_corners_planar(
        scene, jnp.asarray(camera.cam_orbit(0.7)), 128, 128)
    return setup_triangles_planar(xs, ys, zs, 128, 128)


@pytest.mark.parametrize("order", ["direct", "plane", "tri"])
def test_build_queue_f32_dots_are_highest(order):
    """Integers carried through f32 one-hot matmuls are exact only at full
    f32 precision; a TF32 pass would corrupt slot positions and ids."""
    from rustexp_tpu.ops import raster_queue as rq

    setup = _sphere_setup()
    closed = jax.make_jaxpr(lambda s: rq.build_queue(
        s, 128, 128, s_cap=32, m_y=3, m_x=2, t_cap=256, order=order))(setup)
    n = _assert_f32_dots_highest(closed)
    if order in ("direct", "plane"):
        assert n > 0  # the contractions under test are present


def test_inv_world_to_vp_dots_are_highest():
    from rustexp_tpu.raster import pipeline as pp

    closed = jax.make_jaxpr(lambda e: pp.inv_world_to_vp(e, 512, 512))(
        jnp.asarray([1.0, 0.5, 1.5], jnp.float32))
    assert _assert_f32_dots_highest(closed) == 2


# ------------------------------------------------------------ depth ties

def test_z_one_fragment_loses_to_background():
    """A fragment at exactly z == 1.0 ties the cleared depth and must stay
    hidden (rasterizer.rs:1706: strict less-than against 1.0) — in the
    oracle, the queue kernel and its twin alike."""
    from rustexp_tpu.ops import raster_queue as rq
    from rustexp_tpu.ops.raster_setup import setup_triangles_planar
    from rustexp_tpu.ops.raster_xla import raster_gbuffer_xla

    # tri 0 at z = 1.0 over the left half, tri 1 at z = 0.5 on the right
    xs = jnp.asarray([[5.0, 70.0], [60.0, 120.0], [5.0, 70.0]])
    ys = jnp.asarray([[5.0, 5.0], [5.0, 5.0], [60.0, 60.0]])
    zs = jnp.asarray([[1.0, 0.5]] * 3)
    sp = setup_triangles_planar(xs, ys, zs, 128, 128)
    assert bool(sp.valid.all())
    gx = raster_gbuffer_xla(sp.to_trisetup(), 128, 128)
    tid = np.asarray(gx.tid)
    assert not (tid == 0).any() and (tid == 1).any()
    stats = tuple(int(x) for x in rq.queue_stats(sp, 128, 128))
    s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
    q = rq.build_queue(sp, 128, 128, s_cap=s_cap, m_y=m_y, m_x=m_x,
                       t_cap=t_cap)
    for raster in (rq.raster_attrs_queue, rq.raster_attrs_queue_xla):
        z, mask, _, _ = raster(q, sp, (), 0, 0, 128, 128)
        np.testing.assert_array_equal(np.asarray(mask), tid >= 0)
        np.testing.assert_array_equal(np.asarray(z), np.asarray(gx.z))


# ----------------------------------------------------------- GPU lowering

def _lowers_for_cuda(fn, *args):
    """Lower `fn` for the CUDA platform from this CPU host: the Triton
    kernels are built into the module here (only the PTX compile needs
    the card), so what the Triton route cannot lower fails in this test."""
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


def test_raster_queue_kernel_lowers_for_cuda():
    from rustexp_tpu.ops import raster_queue as rq

    setup = _sphere_setup()
    stats = tuple(int(x) for x in rq.queue_stats(setup, 128, 128))
    s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
    q = rq.build_queue(setup, 128, 128, s_cap=s_cap, m_y=m_y, m_x=m_x,
                       t_cap=t_cap)
    one = jnp.ones_like(setup.z0)
    extra = (one,) * 3 * 7
    text = _lowers_for_cuda(
        lambda q, s, e: rq.raster_attrs_queue(q, s, e, 4, 3, 128, 128,
                                              interpret=False),
        q, setup, extra)
    assert "triton" in text


def test_nbody_kernel_lowers_for_cuda():
    from rustexp_tpu.ops import nbody_pallas

    x = jnp.zeros((1024,), jnp.float32)
    text = _lowers_for_cuda(
        lambda x, m: nbody_pallas.forces_pallas(x, x, m, interpret=False),
        x, x + 1.0)
    assert "triton" in text
