"""Offline animation renderer — camera-path turntables at full device rate.

The interactive loop renders one frame per dispatch; for offline animation
(the reference's analog is holding the app open while the camera orbits,
App.hs:196-214) the whole clip renders as ONE jitted scan per chunk: each
frame re-runs transform -> setup -> full in-graph queue build -> raster ->
shade at its own eye (the moving-camera path, app/benchmark.py
bench_scene_moving), and frames stream back in chunks to bound device
memory.

Note on reported times: they include pulling every rendered frame to the
host (32 MB/chunk at 512^2).

Usage:
    python -m rustexp_tpu.app.cli rasterizer --animate 120 --out /tmp/turn
"""

from __future__ import annotations

import time

import numpy as np

CHUNK_FRAMES = 32  # frames per dispatch: 32 x 1 MB @ 512^2 in HBM


def render_turntable(mesh_idx: int = 0, shader_idx: int = 5, env_idx: int = 0,
                     bg_idx: int = 0, per_pixel: bool = False,
                     n_frames: int = 60, fps: float = 60.0, w: int = 512,
                     h: int = 512, out_prefix: str = "", overlay: bool = False,
                     tick0: float = 0.0, gif_path: str = ""):
    """Render n_frames along the mesh's camera path; returns seconds/frame.

    ``gif_path`` additionally assembles every frame into one looping
    animated GIF (core/gif.py) at the turntable's fps.
    """
    import jax
    import jax.numpy as jnp

    from ..assets import cubemap, mesh
    from ..core.framebuffer import to_rgb8_topleft, write_png
    from ..ops.raster_queue import build_queue, suggest_queue_config
    from ..ops.raster_setup import setup_triangles_planar
    from ..raster import camera, pipeline as pp

    from ..ops.raster_queue import TILE_H, TILE_W

    m = mesh.get_mesh(mesh_idx)
    scene = pp.make_scene(m, cubemap.get_cm_set(env_idx))
    cam = mesh.mesh_camera(mesh_idx)
    ticks = tick0 + np.arange(n_frames, dtype=np.float64) / fps
    eyes = np.stack([camera.camera_eye(cam, t) for t in ticks]).astype(
        np.float32)

    # The flat-queue kernel needs TILE_H x TILE_W tileable frames; odd
    # sizes scan through the whole-frame XLA oracle instead.
    tileable = h % TILE_H == 0 and w % TILE_W == 0
    if tileable:
        # Static queue caps: max stats over sampled path eyes, with margin.
        # This scan rebuilds the queue every frame, so the shade
        # granularity uses the per-frame-rebuild threshold (the finer
        # build work recurs every frame, exactly like bench_scene_moving).
        from ..ops.raster_queue import SHADE_W, choose_shade_w

        stats = [jax.device_get(pp._queue_stats_jit(
            scene, jnp.asarray(eyes[i]), w, h))
            for i in range(0, n_frames, max(1, n_frames // 8))]
        agg = tuple(max(int(s[j]) for s in stats) for j in range(5))
        shade_w = choose_shade_w(agg[3], agg[4], rebuild_per_frame=True,
                                 per_pixel=per_pixel)
        occ = agg[3] if shade_w == SHADE_W else agg[4]
        s_cap, m_y, m_x, t_cap = suggest_queue_config(agg[:3] + (occ,))

    @jax.jit
    def chunk(scene, eyes_c, ticks_c):
        def body(ov, et):
            e, t = et
            if tileable:
                xs, ys, zs, _, _, _ = pp.transform_corners_planar(
                    scene, e, w, h)
                setup = setup_triangles_planar(xs, ys, zs, w, h)
                queue = build_queue(setup, h, w, s_cap=s_cap, m_y=m_y,
                                    m_x=m_x, t_cap=t_cap, shade_w=shade_w)
                fb, overflow = pp.render_frame(
                    scene, e, t, w=w, h=h, mode=pp.MODE_FILL,
                    per_pixel=per_pixel, shader_idx=shader_idx, bg_idx=bg_idx,
                    backend="queue", raster_queue=queue,
                    return_overflow=True)
            else:
                fb, overflow = pp.render_frame(
                    scene, e, t, w=w, h=h, mode=pp.MODE_FILL,
                    per_pixel=per_pixel, shader_idx=shader_idx, bg_idx=bg_idx,
                    return_overflow=True)
            return ov | overflow, fb
        ov, fbs = jax.lax.scan(body, jnp.bool_(False), (eyes_c, ticks_c))
        return ov, fbs

    times = []
    frame_no = 0
    gif_frames = [] if gif_path else None
    for i, c0 in enumerate(range(0, n_frames, CHUNK_FRAMES)):
        ec = eyes[c0 : c0 + CHUNK_FRAMES]
        tc = ticks[c0 : c0 + CHUNK_FRAMES].astype(np.float32)
        live = len(ec)
        if live < CHUNK_FRAMES:
            # Pad the tail chunk to the static scan length: a shorter
            # array is a NEW shape, and the full-scan recompile (seconds)
            # would land inside the "sustained" timing. Pad frames repeat the last eye and are
            # sliced off below.
            pad = CHUNK_FRAMES - live
            ec = np.concatenate([ec, np.repeat(ec[-1:], pad, axis=0)])
            tc = np.concatenate([tc, np.repeat(tc[-1:], pad, axis=0)])
        t0 = time.perf_counter()
        ov, fbs = chunk(scene, jnp.asarray(ec), jnp.asarray(tc))
        fbs = np.asarray(fbs)[:live]
        if i > 0:
            # First chunk's wall time is dominated by the one-off XLA
            # compile of the scan; report sustained chunks only.
            times.append((time.perf_counter() - t0) / len(ec))
        elif n_frames <= CHUNK_FRAMES:
            # Single-chunk clip: the only dispatch above paid the compile,
            # so re-dispatch the compiled chunk purely for timing — the
            # reported median stays compile-excluded (ADVICE r3; the CLI
            # labels it "sustained").
            ecj, tcj = jnp.asarray(ec), jnp.asarray(tc)
            t0 = time.perf_counter()
            _, fbs2 = chunk(scene, ecj, tcj)
            np.asarray(fbs2)
            times.append((time.perf_counter() - t0) / len(ec))
        if bool(ov):
            raise RuntimeError(
                "queue caps overflowed mid-path; re-run (caps are sampled "
                "with margin — a pathological camera path can exceed them)")
        for j in range(fbs.shape[0]):
            fb = fbs[j]
            if overlay and (out_prefix or gif_frames is not None):
                from ..core.font import draw_text

                fb = draw_text(fb, f"frame {frame_no} "
                                   f"tick {ticks[frame_no]:.3f}")
            if out_prefix:
                write_png(f"{out_prefix}_{frame_no:04d}.png",
                          to_rgb8_topleft(fb))
            if gif_frames is not None:
                gif_frames.append(to_rgb8_topleft(fb))
            frame_no += 1
    if gif_frames:
        from ..core.gif import write_gif

        write_gif(gif_path, gif_frames, fps=fps)
    return times
