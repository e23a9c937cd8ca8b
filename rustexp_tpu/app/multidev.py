"""Multi-device experiment driver — the user-facing `--devices N` path.

This wires the sharded PRODUCTION paths (flat-queue raster bands, block
Barnes-Hut, SWAR GoL halos) to the CLI. The reference exposes its
parallelism interactively through thread-count keys
(RustGoLExperiment.hs:78-91, RustNBodyExperiment.hs:95-98); the analog
here is a device-mesh width: a 1-D mesh over the first N visible devices
(GPUs of one host, joined all to all, so the mesh shape follows the
algorithm alone).

Without N GPUs, run the semantics on virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m rustexp_tpu.app.cli gol --devices 8 --frames 4
"""

from __future__ import annotations

import time

import numpy as np


def _mesh(n_dev: int, axis: str):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < n_dev:
        raise SystemExit(
            f"--devices {n_dev}: only {len(devs)} JAX devices visible. "
            f"For a virtual mesh: JAX_PLATFORMS=cpu "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n_dev}")
    return Mesh(np.array(devs[:n_dev]), axis_names=(axis,))


def run_multidevice(experiment: str, n_dev: int, frames: int, size: int,
                    out: str, overlay: bool = True,
                    steps_per_frame: int = 8, grid: int = 0,
                    keys: str = "", gif_path: str = ""):
    """Run `frames` sharded sim/render rounds; returns per-frame seconds.

    ``keys`` are the reference keybindings applied to a single-device
    experiment state BEFORE sharding — they select the scene/config
    (GoL patterns, N-body resets + dt/theta, rasterizer mesh/shader/
    envmap/bg/per-pixel) exactly as in the single-device loop, then the
    resulting configuration runs over the mesh.

    Single-device helpers (render, overlay) run on the mesh's first
    device via jax.default_device.
    """
    import jax
    import jax.numpy as jnp

    from ..core.framebuffer import to_rgb8_topleft, write_png
    from ..core.font import draw_text

    axis = "p" if experiment == "nbody" else "rows"
    mesh = _mesh(n_dev, axis)
    jax.config.update("jax_default_device", mesh.devices.flat[0])

    w = h = size
    times = []
    gif_frames = [] if gif_path else None

    def present(i, fb, status):
        if overlay:
            fb = draw_text(fb, status)
        if out:
            path = f"{out}_{i:03d}.png"
            write_png(path, to_rgb8_topleft(np.asarray(fb)))
            print(f"wrote {path}")
        if gif_frames is not None:
            gif_frames.append(to_rgb8_topleft(np.asarray(fb)))
        print(f"[{i}] {status}")

    def finish():
        if gif_frames:
            from ..core.gif import write_gif

            write_gif(gif_path, gif_frames, fps=10.0)
            print(f"wrote {gif_path}")
        return times

    if experiment == "gol":
        from ..parallel import gol_shard
        from ..sims.gol import GRID_WDH, GoLExperiment, gol_render

        gw = grid or GRID_WDH  # --grid N forwards here (CLI contract)
        # Init + keys through the experiment: the default 'ark' pattern
        # and the R/G/A/F/K seeding keys behave exactly as single-device.
        exp = GoLExperiment()
        st = exp.init(n=gw)
        for kk in keys:
            st = exp.handle_key(st, kk)
        g0 = jnp.asarray(st.grid, jnp.int32)
        # "bits" (SWAR) needs per-shard rows % 32 == 0 and a halo (k
        # rounded up to 16 rows) that fits the shard; "roll" handles
        # anything that shards.
        if gw % n_dev:
            raise SystemExit(
                f"--grid {gw} doesn't divide over {n_dev} devices; "
                f"pick a grid divisible by the device count")
        rows = gw // n_dev
        halo = -(-steps_per_frame // 16) * 16
        backend = "bits" if rows % 32 == 0 and halo <= rows else "roll"
        step = gol_shard.make_multi_step(mesh, k=steps_per_frame,
                                         backend=backend)
        g = gol_shard.shard_grid(g0, mesh)
        gens = 0
        for i in range(frames):
            t0 = time.perf_counter()
            g = step(g)
            g.block_until_ready()
            dt = time.perf_counter() - t0
            times.append(dt)
            gens += steps_per_frame
            fb = gol_render(g.astype(jnp.uint8), jnp.zeros(w), jnp.zeros(h))
            cells = gw * gw * steps_per_frame / dt
            present(i, fb, f"{gw}x{gw} Grid, {gens} Gens, "
                           f"{n_dev} dev [{backend}], {cells:.3g} cells/s")
        return finish()

    if experiment == "nbody":
        from ..ops.nbody_bh import theta_to_k
        from ..parallel import nbody_shard
        from ..sims.nbody import NBodyExperiment, nbody_render, stable_orbits

        exp = NBodyExperiment()
        if keys:
            # Q/W/E resets, X/x dt, A/a theta — reference keybindings
            # applied single-device, then the configuration is sharded.
            st = exp.init()
            for kk in keys:
                st = exp.handle_key(st, kk)
            px, py, vx, vy, m = st.px, st.py, st.vx, st.vy, st.m
            dt_step, theta = float(st.dt), float(st.theta)
        else:
            n0 = 256 * 8 * n_dev       # default: scale bodies with mesh
            px, py, vx, vy, m = stable_orbits(jax.random.PRNGKey(0), n0)
            dt_step, theta = 0.01, 0.85
        n = int(px.shape[0])
        # Same routing policy as single-device (select_backend), with the
        # extra shard constraint that target blocks divide over devices.
        block = next((b for b in NBodyExperiment.BH_BLOCKS
                      if n % b == 0 and (n // b) % n_dev == 0
                      and n // b > 4), None)
        if theta == 0.0 or n < NBodyExperiment.BH_MIN_N or block is None:
            if n % n_dev:
                raise SystemExit(
                    f"--devices {n_dev}: {n} bodies don't shard evenly; "
                    f"pick N divisible by the device count")
            step = nbody_shard.make_step(mesh)
            label = "brute"
        else:
            B = n // block
            step = nbody_shard.make_step_bh(
                mesh, block=block, k_near=min(theta_to_k(theta, B), B))
            label = f"bh(th={theta:.2f})"
        state = nbody_shard.shard_particles((px, py, vx, vy, m), mesh)
        for i in range(frames):
            t0 = time.perf_counter()
            state = step(*state, jnp.float32(dt_step))
            state[0].block_until_ready()
            dt = time.perf_counter() - t0
            times.append(dt)
            fb = nbody_render(state[0], state[1], state[2], state[3], w, h)
            present(i, fb, f"{i + 1} Steps, SPS: {1 / dt:.0f}, "
                           f"{dt * 1e3:.2f}ms, {n} Bodies, {n_dev} dev, "
                           f"{label}")
        return finish()

    if experiment == "rasterizer":
        from ..assets import cubemap, mesh as mesh_assets
        from ..parallel import raster_shard
        from ..raster import camera, pipeline as pp

        from ..ops.raster_queue import TILE_H

        if h % (n_dev * TILE_H):
            raise SystemExit(f"--size {size} not divisible into {n_dev} "
                             f"{TILE_H}-row-tileable bands")
        # Scene selection through the experiment's keybindings (Q/W mesh,
        # A/S shader, Z/X envmap, 1/2 background, P per-pixel) — defaults
        # match the reference: Killeroo, CMRefl, Grace, per-vertex.
        from ..sims.rasterizer import RasterizerExperiment

        rexp = RasterizerExperiment()
        rst = rexp.init()
        for kk in keys:
            rst = rexp.handle_key(rst, kk)
        m = mesh_assets.get_mesh(rst.mesh_idx)
        scene = pp.make_scene(m, cubemap.get_cm_set(rst.env_idx))
        cam = mesh_assets.mesh_camera(rst.mesh_idx)
        # Moving-camera path: each device rebuilds its band's queue
        # IN-GRAPH every frame (no cached structures, no host rebuild
        # trips). Static caps sampled along the camera path.
        ticks = [i / 60.0 for i in range(frames)]
        cap_eyes = [jnp.asarray(camera.camera_eye(cam, t))
                    for t in ticks[:: max(1, frames // 8)]]
        render = raster_shard.make_sharded_queue_render_moving(
            mesh, scene, cap_eyes, w=w, h=h, per_pixel=rst.per_pixel,
            shader_idx=rst.shader_idx, bg_idx=rst.bg_idx)
        for i in range(frames):
            tick = ticks[i]
            eye = jnp.asarray(camera.camera_eye(cam, tick))
            t0 = time.perf_counter()
            fb, stale = render(scene, eye, jnp.float32(tick))
            fb.block_until_ready()
            if bool(stale):  # camera exceeded the sampled caps: widen once
                cap_eyes = cap_eyes + [eye]
                render = raster_shard.make_sharded_queue_render_moving(
                    mesh, scene, cap_eyes, w=w, h=h,
                    per_pixel=rst.per_pixel, shader_idx=rst.shader_idx,
                    bg_idx=rst.bg_idx)
                fb, stale = render(scene, eye, jnp.float32(tick))
                fb.block_until_ready()
            dt = time.perf_counter() - t0
            times.append(dt)
            present(i, fb, f"{1 / dt:.1f}FPS {dt * 1e3:.2f}ms | {n_dev} dev "
                           f"| {m.name} | {pp.sh.shader_name(rst.shader_idx)} "
                           f"| {m.num_tris} Tri")
        return finish()

    if experiment == "sine":
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..sims.sine import sine_frame

        wi = jnp.arange(w, dtype=jnp.float32)
        hi = jnp.arange(h, dtype=jnp.float32)
        fn = jax.jit(sine_frame, in_shardings=(
            NamedSharding(mesh, P()), NamedSharding(mesh, P("rows")),
            NamedSharding(mesh, P())),
            out_shardings=NamedSharding(mesh, P("rows")))
        for i in range(frames):
            t0 = time.perf_counter()
            fb = fn(wi, hi, jnp.float32(i / 60.0))
            fb.block_until_ready()
            dt = time.perf_counter() - t0
            times.append(dt)
            present(i, fb, f"sine {dt * 1e3:.2f}ms | {n_dev} dev")
        return finish()

    raise SystemExit(f"--devices does not support experiment {experiment!r}")
