"""Rasterizer experiment: the user-visible driver around raster/pipeline.

Reference: hs-src/RustRasterizerExperiment.hs — state defaults (per-vertex
shading, Fill mode, mesh 0 Killeroo, shader 5 CMRefl, envmap 0 Grace, bg 0,
RustRasterizerExperiment.hs:68-75), wrapping selection keys
(RustRasterizerExperiment.hs:127-143), and the status string with frame
stats, scene names, and triangle count (RustRasterizerExperiment.hs:94-126).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax

from ..assets import cubemap, mesh
from ..core.timing import FrameTimes
from ..raster import camera, pipeline as pp


# Background XLA warm-up of rasterizer configs: every (mesh, shader, mode,
# per-pixel, bg, size) combination is a distinct XLA program whose first
# compile takes seconds; the shared Prewarmer (core/prewarm.py) compiles
# them on a daemon thread so switches land warm. Re-exported here for
# existing callers.
from ..core.prewarm import Prewarmer


def _work_kind(w: int, h: int) -> str:
    """"queue" (the flat-queue kernel, every mesh size) when the frame
    tiles, else "xla" (the whole-frame oracle)."""
    from ..ops.raster_queue import TILE_H, TILE_W

    return "xla" if h % TILE_H or w % TILE_W else "queue"


def _warm_config(cfg, tick: float):
    """Render one frame of `cfg` to populate the jit caches (discarded)."""
    mesh_idx, env_idx, shader_idx, mode, per_pixel, bg_idx, w, h = cfg
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), tick)
    m = mesh.get_mesh(mesh_idx)
    scene = pp.make_scene(m, cubemap.get_cm_set(env_idx))
    kw = dict(w=w, h=h, mode=mode, per_pixel=per_pixel,
              shader_idx=shader_idx, bg_idx=bg_idx, return_overflow=True)
    kw["backend"] = _work_kind(w, h)
    if kw["backend"] == "queue":
        kw["raster_queue"] = pp.build_scene_queue(scene, eye, w, h)
    fb, _ = pp.render_frame(scene, eye, tick, **kw)
    jax.block_until_ready(fb)


@dataclass
class RasterState:
    per_pixel: bool = False
    mode: int = pp.MODE_FILL
    mesh_idx: int = 0
    shader_idx: int = 5
    env_idx: int = 0
    bg_idx: int = 0
    backend: str = "auto"
    frame_times: FrameTimes = field(default_factory=FrameTimes)
    _scene_cache: tuple | None = None  # (mesh_idx, env_idx, Scene)
    # Async config switch (VERDICT r4 #5): a key whose target config is
    # not yet compiled parks its field changes here; render() keeps
    # presenting the current (warm) config, status() shows
    # "compiling ..." and the switch lands the frame the Prewarmer
    # finishes. None = no switch in flight. prewarm=None disables the
    # machinery entirely (headless/bench paths).
    pending: dict | None = None
    prewarm: Prewarmer | None = None
    _last_wh: tuple | None = None   # render size, for handle_key's cfg
    _last_tick: float = 0.0         # camera tick for urgent warm requests


class RasterizerExperiment:
    name = "Rasterizer"

    # User-visible config fields; any change means a different XLA
    # program (env only changes data, but a warm render is ~free then).
    _CFG_FIELDS = ("mesh_idx", "env_idx", "shader_idx", "mode",
                   "per_pixel", "bg_idx")

    def __init__(self, prewarm: bool = False):
        self._prewarm = prewarm

    def init(self, **config) -> RasterState:
        st = RasterState(**config)
        if self._prewarm and st.prewarm is None:
            st.prewarm = Prewarmer(_warm_config)
        return st

    @staticmethod
    def _cfg(state: RasterState, w: int, h: int, over: dict | None = None):
        d = {f: getattr(state, f) for f in
             RasterizerExperiment._CFG_FIELDS}
        if over:
            d.update(over)
        return (d["mesh_idx"], d["env_idx"], d["shader_idx"], d["mode"],
                d["per_pixel"], d["bg_idx"], w, h)

    def _spec_warm(self, state: RasterState, w: int, h: int, tick: float):
        """Queue the neighbors of the current config, nearest keys first
        (the reference's q/w/a/s cycle order)."""
        c = {f: getattr(state, f) for f in self._CFG_FIELDS}
        neighbors = (
            {"mesh_idx": (c["mesh_idx"] + 1) % mesh.NUM_MESHES},
            {"mesh_idx": (c["mesh_idx"] - 1) % mesh.NUM_MESHES},
            {"shader_idx": (c["shader_idx"] + 1) % pp.sh.NUM_SHADERS},
            {"shader_idx": (c["shader_idx"] - 1) % pp.sh.NUM_SHADERS},
            {"per_pixel": not c["per_pixel"]},
            {"mode": (c["mode"] + 1) % len(pp.MODE_NAMES)},
            {"bg_idx": (c["bg_idx"] + 1) % pp.NUM_BACKGROUNDS},
            {"bg_idx": (c["bg_idx"] - 1) % pp.NUM_BACKGROUNDS},
            {"env_idx": (c["env_idx"] + 1) % cubemap.NUM_CM_SETS},
            {"env_idx": (c["env_idx"] - 1) % cubemap.NUM_CM_SETS},
        )
        for over in neighbors:
            state.prewarm.request(self._cfg(state, w, h, over), tick)

    def _scene(self, state: RasterState, w: int, h: int, eye):
        """Scene + cached raster work structure (rebuilt when stale).

        Tileable frames use the flat work queue; the rest the whole-frame
        XLA oracle (_work_kind).
        """
        key = (state.mesh_idx, state.env_idx, w, h)
        if state._scene_cache is None or state._scene_cache[0] != key:
            m = mesh.get_mesh(state.mesh_idx)
            scene = pp.make_scene(m, cubemap.get_cm_set(state.env_idx))
            state._scene_cache = (key, scene, None)
            self._rebuild(state, scene, eye, w, h,
                          _work_kind(w, h))
        return state._scene_cache[1], state._scene_cache[2]

    def _rebuild(self, state: RasterState, scene, eye, w: int, h: int,
                 kind: str):
        key = state._scene_cache[0]
        work = (kind, pp.build_scene_queue(scene, eye, w, h)
                if kind == "queue" else None)
        state._scene_cache = (key, scene, work)
        return work

    def step(self, state: RasterState) -> RasterState:
        return state  # all per-frame work happens in render (like the reference)

    def _frame_kwargs(self, state, work, w, h):
        kind, data = work
        kw = dict(
            w=w, h=h, mode=state.mode, per_pixel=state.per_pixel,
            shader_idx=state.shader_idx, bg_idx=state.bg_idx,
            return_overflow=True,
        )
        backend = kind if state.backend == "auto" else state.backend
        kw["backend"] = backend
        if backend in ("queue", "queue_xla"):
            kw["raster_queue"] = data
        return kw

    def render(self, state: RasterState, w: int, h: int, tick: float = 0.0):
        if state.prewarm is not None:
            state._last_wh = (w, h)
            state._last_tick = tick
            if state.pending is not None:
                pcfg = self._cfg(state, w, h, state.pending)
                if state.prewarm.is_warm(pcfg):
                    for f, v in state.pending.items():
                        setattr(state, f, v)
                    state.pending = None
                else:
                    # keep presenting the current (warm) config; the
                    # urgent request is already queued (handle_key)
                    state.prewarm.request(pcfg, tick, urgent=True)
        eye = camera.camera_eye(mesh.mesh_camera(state.mesh_idx), tick)
        scene, work = self._scene(state, w, h, eye)
        t0 = time.perf_counter()
        fb, stale = pp.render_frame(scene, eye, tick,
                                    **self._frame_kwargs(state, work, w, h))
        if bool(stale):
            # Camera moved beyond the cached work structure (or its static
            # caps overflowed): rebuild at this viewpoint and re-render.
            # The reference's dynamic bins are exact by construction
            # (rasterizer.rs:2115-2163); static shapes trade that for this
            # loud rebuild.
            from ..core.trace import trace_info

            trace_info(f"raster structure stale at tick {tick:.2f}; rebuilding")
            work = self._rebuild(state, scene, eye, w, h, work[0])
            fb, stale = pp.render_frame(
                scene, eye, tick, **self._frame_kwargs(state, work, w, h))
        jax.block_until_ready(fb)
        state.frame_times.push(time.perf_counter() - t0)
        if state.prewarm is not None:
            # rendering IS the warm-up for the current config; then seed
            # the speculative neighbor set (request() dedups)
            state.prewarm.mark_warm(self._cfg(state, w, h))
            self._spec_warm(state, w, h, tick)
        return fb

    _PENDING_NAMES = {
        "mesh_idx": lambda v: f"Mesh {mesh.mesh_name(v)}",
        "shader_idx": lambda v: f"Shdr {pp.sh.shader_name(v)}",
        "mode": lambda v: f"Mode {pp.MODE_NAMES[v]}",
        "per_pixel": lambda v: f"PerPixel {'On' if v else 'Off'}",
        "env_idx": lambda v: f"Env {cubemap.cm_set_name(v)}",
        "bg_idx": lambda v: f"Bg {v}",
    }

    def status(self, state: RasterState) -> str:
        fps, med, _, _ = state.frame_times.stats()
        ms = med * 1000.0
        m = mesh.get_mesh(state.mesh_idx)
        s = (
            f"{fps:.1f}FPS | {ms:.2f}ms | Mode: {pp.MODE_NAMES[state.mode]} "
            f"| PerPixel: {'On' if state.per_pixel else 'Off'} "
            f"| Mesh: {mesh.mesh_name(state.mesh_idx)} ({m.num_tris} Tri) "
            f"| Shdr: {pp.sh.shader_name(state.shader_idx)} "
            f"| Env: {cubemap.cm_set_name(state.env_idx)} | Bg: {state.bg_idx}"
        )
        if state.pending:
            what = ", ".join(self._PENDING_NAMES[f](v)
                             for f, v in state.pending.items())
            s = f"compiling {what}... | " + s
        return s

    def handle_key(self, state: RasterState, key: str) -> RasterState:
        """Wrapping scene-selection keys (RustRasterizerExperiment.hs:127-143).

        With a Prewarmer attached, a key whose target program is not
        compiled yet goes PENDING: the viewer keeps presenting the
        current config (status shows "compiling ..."), the target
        compiles urgently on the warm thread, and render() lands the
        switch the frame it is ready — the async answer to the
        reference's instant switching (App.hs:178-185). Warm targets
        (and the no-prewarm configuration) switch immediately.
        """
        key = key.upper() if len(key) == 1 else key

        def base(f):
            if state.pending and f in state.pending:
                return state.pending[f]
            return getattr(state, f)

        over: dict | None = None
        if key == "M":
            over = {"mode": (base("mode") + 1) % len(pp.MODE_NAMES)}
        elif key == "P":
            over = {"per_pixel": not base("per_pixel")}
        elif key == "Q":
            over = {"mesh_idx": (base("mesh_idx") - 1) % mesh.NUM_MESHES}
        elif key == "W":
            over = {"mesh_idx": (base("mesh_idx") + 1) % mesh.NUM_MESHES}
        elif key == "A":
            over = {"shader_idx":
                    (base("shader_idx") - 1) % pp.sh.NUM_SHADERS}
        elif key == "S":
            over = {"shader_idx":
                    (base("shader_idx") + 1) % pp.sh.NUM_SHADERS}
        elif key == "Z":
            over = {"env_idx": (base("env_idx") - 1) % cubemap.NUM_CM_SETS}
        elif key == "X":
            over = {"env_idx": (base("env_idx") + 1) % cubemap.NUM_CM_SETS}
        elif key == "1":
            over = {"bg_idx": (base("bg_idx") - 1) % pp.NUM_BACKGROUNDS}
        elif key == "2":
            over = {"bg_idx": (base("bg_idx") + 1) % pp.NUM_BACKGROUNDS}
        elif key == "B":
            from ..app.benchmark import run_suite

            run_suite()
        if over is None:
            return state

        if state.prewarm is None or state._last_wh is None:
            for f, v in over.items():
                setattr(state, f, v)
            return state
        merged = dict(state.pending or {})
        merged.update(over)
        w, h = state._last_wh
        cfg = self._cfg(state, w, h, merged)
        if state.prewarm.is_warm(cfg):
            for f, v in merged.items():
                setattr(state, f, v)
            state.pending = None
        else:
            state.pending = merged
            state.prewarm.request(cfg, state._last_tick, urgent=True)
        return state
