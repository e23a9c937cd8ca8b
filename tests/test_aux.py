"""Auxiliary-subsystem tests: tracing, timing stats, offline animation.

Covers the reference's Trace (hs-src/Trace.hs), Timing/BoundedSequence/
Median (hs-src/Timing.hs:21-34, BoundedSequence.hs:16-46, Median.hs:7-15)
re-expressions, and the offline turntable renderer (app/animate.py) that
replaces holding the reference app open while the camera orbits.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from rustexp_tpu.core import timing, trace


# ---------------------------------------------------------------- trace

def test_trace_levels_and_file_sink(tmp_path, capsys):
    log = str(tmp_path / "t.log")
    trace.setup(level=trace.TraceLevel.WARN, file_path=log, echo=True,
                color=False)
    try:
        trace.trace_error("boom")
        trace.trace_warn("careful")
        trace.trace_info("chatty")  # above level -> dropped
        err = capsys.readouterr().err
        assert "boom" in err and "careful" in err and "chatty" not in err
        lines = open(log).read().splitlines()
        assert len(lines) == 2
        # header: LEVEL [tid] HH:MM:SS.mmm | msg  (Trace.hs:71-100 analog)
        assert lines[0].startswith("ERROR [") and lines[0].endswith("| boom")
        assert lines[1].startswith("WARN [")
    finally:
        trace.setup(level=trace.TraceLevel.WARN, file_path=None, echo=True)


def test_trace_none_level_silences_everything(tmp_path, capsys):
    trace.setup(level=trace.TraceLevel.NONE, echo=True, color=False)
    try:
        trace.trace_error("invisible")
        assert "invisible" not in capsys.readouterr().err
    finally:
        trace.setup(level=trace.TraceLevel.WARN, file_path=None, echo=True)


def test_trace_color_tags(capsys):
    trace.setup(level=trace.TraceLevel.INFO, echo=True, color=True)
    try:
        trace.trace_info("tinted")
        err = capsys.readouterr().err
        assert "\x1b[36m" in err and "\x1b[0m" in err
    finally:
        trace.setup(level=trace.TraceLevel.WARN, file_path=None, echo=True)


def test_trace_and_raise():
    trace.setup(level=trace.TraceLevel.NONE, echo=False)
    try:
        with pytest.raises(RuntimeError, match="fatal thing"):
            trace.trace_and_raise("fatal thing")
    finally:
        trace.setup(level=trace.TraceLevel.WARN, file_path=None, echo=True)


# --------------------------------------------------------------- timing

def test_median_odd_even_empty():
    assert timing.median([3.0, 1.0, 2.0]) == 2.0
    assert timing.median([4.0, 1.0, 2.0, 3.0]) == 2.5
    assert timing.median([]) == 0.0


def test_frame_times_ring_bounds_and_stats():
    ft = timing.FrameTimes(limit=4)
    for dt in [0.010, 0.020, 0.030, 0.040, 0.050]:
        ft.push(dt)
    # 60-deep-ring analog: oldest (0.010) evicted at limit 4
    assert len(ft.times) == 4
    fps, med, lo, hi = ft.stats()
    assert lo == 0.020 and hi == 0.050
    assert med == pytest.approx(0.035)
    assert fps == pytest.approx(1.0 / 0.035)
    s = ft.status_string()
    assert "FPS" in s and "Worst" in s and "Best" in s


def test_frame_times_empty_stats():
    ft = timing.FrameTimes()
    assert ft.stats() == (0.0, 0.0, 0.0, 0.0)
    assert "0.0FPS" in ft.status_string()


def test_time_it_returns_elapsed_and_result():
    dt, out = timing.time_it(lambda a, b: a + b, 2, b=3)
    assert out == 5 and dt >= 0.0


def test_get_tick_monotonic():
    a = timing.get_tick()
    b = timing.get_tick()
    assert b >= a >= 0.0


# ------------------------------------------------------------------ gif

def test_gif_roundtrip_exact_palette(tmp_path):
    """Frames with <=256 distinct colors quantize losslessly; PIL must
    decode every frame back bit-exact, with the loop flag and duration."""
    PIL = pytest.importorskip("PIL.Image")
    from rustexp_tpu.core.gif import write_gif

    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (17, 3), np.uint8)
    frames = [pal[rng.integers(0, len(pal), (40, 56))] for _ in range(3)]
    path = str(tmp_path / "a.gif")
    write_gif(path, frames, fps=20.0)

    im = PIL.open(path)
    assert im.size == (56, 40)
    got = []
    try:
        while True:
            got.append(np.asarray(im.convert("RGB")))
            im.seek(im.tell() + 1)
    except EOFError:
        pass
    assert len(got) == 3
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    assert im.info.get("loop", None) == 0
    assert im.info.get("duration", 0) == 50  # 20 fps -> 50 ms


def test_gif_gradient_quantization_quality(tmp_path):
    """A smooth gradient through the 256-color median-cut palette must
    stay within a small per-channel error (no gross banding/corruption)."""
    PIL = pytest.importorskip("PIL.Image")
    from rustexp_tpu.core.gif import write_gif

    y, x = np.mgrid[0:64, 0:64]
    f0 = np.stack([x * 4, y * 4, (x + y) * 2], axis=-1).astype(np.uint8)
    f1 = np.roll(f0, 8, axis=1)
    path = str(tmp_path / "g.gif")
    write_gif(path, [f0, f1], fps=10.0)
    im = PIL.open(path)
    got0 = np.asarray(im.convert("RGB")).astype(np.int32)
    err = np.abs(got0 - f0.astype(np.int32))
    assert err.mean() < 4.0 and err.max() <= 48


# ------------------------------------------------------------- platform

def test_package_import_initializes_no_backend():
    """Importing the package must not create device arrays.

    A module-level jnp.asarray initializes the JAX backend at import
    time, BEFORE entry points configure JAX (compile cache, platform) —
    and on a GPU it would reserve the card's memory merely by importing.
    """
    import subprocess
    import sys

    code = (
        "import jax\n"
        "from jax._src import xla_bridge\n"
        "import rustexp_tpu\n"
        "import rustexp_tpu.core.platform, rustexp_tpu.core.colors\n"
        "import rustexp_tpu.core.framebuffer, rustexp_tpu.core.checkpoint\n"
        "import rustexp_tpu.sims.sine, rustexp_tpu.sims.gol\n"
        "import rustexp_tpu.sims.nbody, rustexp_tpu.sims.rasterizer\n"
        "import rustexp_tpu.ops.gol_bits, rustexp_tpu.ops.nbody_bh\n"
        "import rustexp_tpu.ops.nbody_pallas, rustexp_tpu.ops.cuda_ffi\n"
        "import rustexp_tpu.ops.raster_queue, rustexp_tpu.raster.pipeline\n"
        "import rustexp_tpu.app.cli, rustexp_tpu.app.animate\n"
        "import rustexp_tpu.parallel.gol_shard\n"
        "assert not xla_bridge._backends, sorted(xla_bridge._backends)\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


# -------------------------------------------------------------- animate

@pytest.mark.parametrize("wh", [128, 64])
def test_turntable_renders_frames_along_camera_path(tmp_path, wh):
    """Two cube frames through the full in-graph rebuild scan.

    Checks the offline path end to end: per-frame eyes from the mesh's
    camera animation, static queue caps sampled over the path, PNG output
    per frame, and that successive frames actually differ (the camera
    moved). 128^2 runs the flat-queue scan; 64^2 (not TILE_W-tileable)
    exercises the render_frame auto-backend fallback.
    """
    from rustexp_tpu.app import animate
    from rustexp_tpu.core.framebuffer import read_png

    prefix = str(tmp_path / "turn")
    times = animate.render_turntable(
        mesh_idx=9, shader_idx=2, env_idx=0, bg_idx=0, per_pixel=False,
        n_frames=2, fps=4.0, w=wh, h=wh, out_prefix=prefix)
    assert len(times) >= 1 and all(t > 0 for t in times)
    paths = sorted(glob.glob(prefix + "_*.png"))
    assert [os.path.basename(p) for p in paths] == [
        "turn_0000.png", "turn_0001.png"]
    f0, f1 = read_png(paths[0]), read_png(paths[1])
    assert f0.shape == (wh, wh, 3)
    assert (f0 != f1).any(), "camera did not move between frames"
    # some shaded (non-background) pixels exist in both frames
    for f in (f0, f1):
        col = f.reshape(-1, 3)
        assert len(np.unique(col, axis=0)) > 4


class TestPrewarm:
    """Async rasterizer config switching (VERDICT r4 #5)."""

    def _exp_state(self, w=128, h=128):
        from rustexp_tpu.sims.rasterizer import RasterizerExperiment

        exp = RasterizerExperiment(prewarm=True)
        st = exp.init()
        # first render warms the current config + seeds neighbors
        exp.render(st, w, h, 0.0)
        return exp, st

    def test_key_goes_pending_then_lands(self):
        import time

        exp, st = self._exp_state()
        mesh0 = st.mesh_idx
        st = exp.handle_key(st, "W")  # next mesh: not warm yet -> pending
        if st.pending is not None:
            assert st.mesh_idx == mesh0          # switch NOT applied yet
            assert "compiling" in exp.status(st)
            # keep presenting frames; the switch must land once the
            # background warm completes
            deadline = time.time() + 120
            while st.pending is not None and time.time() < deadline:
                exp.render(st, 128, 128, 0.0)
                time.sleep(0.05)
        assert st.pending is None, "prewarm never landed the switch"
        assert st.mesh_idx == (mesh0 + 1) % __import__(
            "rustexp_tpu.assets.mesh", fromlist=["NUM_MESHES"]).NUM_MESHES
        assert "compiling" not in exp.status(st)
        # rendering the landed config works
        exp.render(st, 128, 128, 0.0)

    def test_warm_target_switches_immediately(self):
        import time

        exp, st = self._exp_state()
        cfg_back = exp._cfg(st, 128, 128, {"per_pixel": not st.per_pixel})
        # wait for the speculative neighbor warm to cover the toggle
        deadline = time.time() + 120
        while not st.prewarm.is_warm(cfg_back) and time.time() < deadline:
            time.sleep(0.05)
        assert st.prewarm.is_warm(cfg_back), "neighbor warm never finished"
        ppx0 = st.per_pixel
        st = exp.handle_key(st, "P")
        assert st.pending is None and st.per_pixel == (not ppx0)

    def test_no_prewarm_keys_apply_directly(self):
        from rustexp_tpu.sims.rasterizer import RasterizerExperiment

        exp = RasterizerExperiment()  # prewarm off (bench/headless)
        st = exp.init()
        m0 = st.mesh_idx
        st = exp.handle_key(st, "W")
        assert st.pending is None and st.mesh_idx != m0


class TestPrewarmerUnit:
    """core/prewarm.Prewarmer mechanics, independent of any experiment."""

    def test_dedup_urgent_priority_and_failure_swallowed(self):
        import threading
        import time

        from rustexp_tpu.core.prewarm import Prewarmer

        order = []
        gate = threading.Event()
        started = threading.Event()

        def warm(cfg, tick):
            started.set()
            gate.wait(10)
            order.append(cfg)
            if cfg == "boom":
                raise RuntimeError("warm failure must be swallowed")

        pw = Prewarmer(warm)
        pw.request("spec1", 0.0)           # starts the thread, blocks on gate
        assert started.wait(10)             # worker holds spec1 at the gate
        pw.request("spec2", 0.0)
        pw.request("boom", 0.0, urgent=True)
        pw.request("spec2", 0.0)            # dedup: queued already
        gate.set()
        deadline = time.time() + 10
        while len(order) < 3 and time.time() < deadline:
            time.sleep(0.02)
        # urgent drains before the remaining spec work; dedup kept one spec2
        assert order == ["spec1", "boom", "spec2"]
        # a failed warm still counts as warmed (the key just pays the
        # compile itself if the program is actually broken)
        assert pw.is_warm("boom") and pw.is_warm("spec1") and pw.is_warm("spec2")
        pw.request("spec2", 0.0)             # dedup: warmed already
        pw.stop()
        assert len(order) == 3

    def test_mark_warm_short_circuits_request(self):
        from rustexp_tpu.core.prewarm import Prewarmer

        calls = []
        pw = Prewarmer(lambda cfg, tick: calls.append(cfg))
        pw.mark_warm("done")
        assert pw.is_warm("done")
        pw.request("done", 0.0)              # no thread start, no call
        assert pw._thread is None and calls == []


class TestNBodyThetaReplan:
    """Async a/A theta replans (ROADMAP 'theta replan feedback'): a theta
    whose K(theta) needs a new step program compiles in the background
    while step() keeps integrating at the current theta."""

    # n=2050 -> block=50, 41 blocks: K(0.85)=27, K(0.80)=30, so one 'a'
    # press crosses a program boundary; small enough for fast CPU jits.
    N = 2050

    def _exp_state(self):
        from rustexp_tpu.sims.nbody import NBodyExperiment

        exp = NBodyExperiment(prewarm=True)
        st = exp.init(n=self.N, theta=0.85)
        st = exp.step(st)  # warms the current program
        return exp, st

    def test_replan_goes_pending_then_lands(self):
        import time

        exp, st = self._exp_state()
        assert exp._step_cfg(self.N, 0.85) != exp._step_cfg(self.N, 0.80), \
            "test premise: the 0.05 nudge must change K"
        st = exp.handle_key(st, "a")
        assert st.pending_theta is not None
        assert abs(st.theta - 0.85) < 1e-9          # NOT applied yet
        assert "compiling th=0.80" in exp.status(st)
        deadline = time.time() + 120
        while st.pending_theta is not None and time.time() < deadline:
            st = exp.step(st)                        # keeps integrating
            time.sleep(0.05)
        assert st.pending_theta is None, "replan never landed"
        assert abs(st.theta - 0.80) < 1e-9
        assert "compiling" not in exp.status(st)
        st = exp.step(st)                            # new program runs
        st.prewarm.stop()

    def test_warm_target_and_presses_stack_from_pending(self):
        import time

        exp, st = self._exp_state()
        st = exp.handle_key(st, "a")                 # pending 0.80
        if st.pending_theta is not None:
            # a second press steps from the PENDING theta, not the live one
            st = exp.handle_key(st, "A")
            tgt = (st.pending_theta if st.pending_theta is not None
                   else st.theta)
            assert abs(tgt - 0.85) < 1e-9
        # back at 0.85 = the already-warm program -> immediate, no pending
        deadline = time.time() + 120
        while st.pending_theta is not None and time.time() < deadline:
            st = exp.step(st)
            time.sleep(0.05)
        assert st.pending_theta is None and abs(st.theta - 0.85) < 1e-9
        st.prewarm.stop()

    def test_mode_reset_carries_warm_thread(self):
        exp, st = self._exp_state()
        pw = st.prewarm
        st2 = exp.handle_key(st, "q")                # orbit reset
        assert st2.prewarm is pw
        assert st2.pending_theta is None
        pw.stop()

    def test_no_prewarm_theta_applies_directly(self):
        from rustexp_tpu.sims.nbody import NBodyExperiment

        exp = NBodyExperiment()                      # bench/headless
        st = exp.init(n=self.N, theta=0.85)
        st = exp.handle_key(st, "a")
        assert st.pending_theta is None and abs(st.theta - 0.80) < 1e-9
