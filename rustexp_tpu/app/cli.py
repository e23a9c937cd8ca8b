"""Headless CLI driver — the engine's main entry point.

Replaces the reference's GLFW window loop (hs-src/Main.hs:48-76,
App.hs:155-215): experiments are selected by name instead of -/= keys,
interactive keybindings become ``--keys`` (a string of the reference's key
characters applied before the run), frames render to PNG instead of an
OpenGL PBO, and the per-frame status overlay prints to stdout.

Usage examples:
    python -m rustexp_tpu.app.cli rasterizer --frames 8 --size 512 \
        --keys WWP --out /tmp/frame
    python -m rustexp_tpu.app.cli gol --frames 4 --keys G
    python -m rustexp_tpu.app.cli nbody --frames 60
    python -m rustexp_tpu.app.cli bench
"""

from __future__ import annotations

import argparse
import sys
import time


def build_experiment(name: str, args):
    if name == "sine":
        from ..sims.sine import SineExperiment

        return SineExperiment()
    if name == "gol":
        from ..sims.gol import GoLExperiment

        return GoLExperiment()
    if name == "nbody":
        from ..sims.nbody import NBodyExperiment

        return NBodyExperiment()
    if name == "rasterizer":
        from ..sims.rasterizer import RasterizerExperiment

        return RasterizerExperiment()
    raise SystemExit(f"unknown experiment {name!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="rustexp_tpu", description=__doc__)
    p.add_argument("experiment",
                   choices=["sine", "gol", "nbody", "rasterizer", "bench"])
    p.add_argument("--frames", type=int, default=4, help="frames to render")
    p.add_argument("--size", type=int, default=512, help="framebuffer size (square)")
    p.add_argument("--keys", default="", help="key events applied before the run "
                   "(reference keybindings, e.g. 'WWP' = next-next-mesh, per-pixel)")
    p.add_argument("--out", default="", help="PNG path prefix (writes <out>_NNN.png)")
    p.add_argument("--overlay", action="store_true", default=True,
                   help="burn the status line into each frame "
                        "(the reference's on-screen overlay, App.hs:106-129)")
    p.add_argument("--no-overlay", dest="overlay", action="store_false",
                   help="render frames without the burned-in status line")
    p.add_argument("--ticks-per-frame", type=float, default=1.0 / 60.0)
    p.add_argument("--runs", type=int, default=20, help="bench: timing runs per scene")
    p.add_argument("--save-state", default="", metavar="PATH",
                   help="write the final experiment state to PATH (npz) "
                        "for later --load-state resume")
    p.add_argument("--load-state", default="", metavar="PATH",
                   help="resume from a --save-state checkpoint instead of "
                        "a fresh init (GoL resumes bit-exactly)")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="rasterizer: render an N-frame camera-path "
                        "turntable as chunked on-device scans (full "
                        "in-graph queue rebuild per frame) to --out")
    p.add_argument("--gif", default="", metavar="PATH",
                   help="additionally assemble the rendered frames into "
                        "one looping animated GIF (dependency-free "
                        "writer, core/gif.py)")
    p.add_argument("--devices", type=int, default=1,
                   help="run the experiment sharded over an N-device mesh "
                        "(production parallel/ paths: GoL SWAR halos, "
                        "block-BH, flat-queue raster bands). Needs N "
                        "visible devices; for a virtual CPU mesh use "
                        "JAX_PLATFORMS=cpu XLA_FLAGS="
                        "--xla_force_host_platform_device_count=N")
    p.add_argument("--grid", type=int, default=0, metavar="N",
                   help="gol: N x N grid instead of the reference's 256")
    p.add_argument("--steps-per-frame", type=int, default=0, metavar="K",
                   help="gol: fuse K generations per rendered frame into "
                        "one on-device dispatch chain")
    args = p.parse_args(argv)

    from ..core.platform import enable_compile_cache

    enable_compile_cache()

    if args.devices > 1:
        from .multidev import run_multidevice

        if args.animate:
            raise SystemExit("--animate renders on a single device; drop "
                             "--devices (the turntable scan already "
                             "amortizes across frames)")
        times = run_multidevice(args.experiment, args.devices, args.frames,
                                args.size, args.out, overlay=args.overlay,
                                steps_per_frame=args.steps_per_frame or 8,
                                grid=args.grid, keys=args.keys,
                                gif_path=args.gif)
        med = sorted(times)[len(times) // 2]
        print(f"{len(times)} frames, median {med * 1e3:.2f} ms "
              f"on {args.devices} devices")
        return 0

    if args.experiment == "bench":
        import json

        from .benchmark import run_suite

        print(json.dumps(run_suite(runs=args.runs)))
        return 0

    if args.animate:
        if args.experiment != "rasterizer":
            raise SystemExit("--animate supports the rasterizer experiment")
        from ..sims.rasterizer import RasterizerExperiment
        from .animate import render_turntable

        # --keys selects the scene exactly as in the frame loop below
        # (reference keybindings: Q/W mesh, A/S shader, Z/X envmap, 1/2
        # background, P per-pixel), then the turntable renders that scene.
        exp = RasterizerExperiment()
        st = exp.init()
        for k in args.keys:
            st = exp.handle_key(st, k)
        times = render_turntable(mesh_idx=st.mesh_idx,
                                 shader_idx=st.shader_idx,
                                 env_idx=st.env_idx, bg_idx=st.bg_idx,
                                 per_pixel=st.per_pixel,
                                 n_frames=args.animate, w=args.size,
                                 h=args.size, out_prefix=args.out,
                                 overlay=args.overlay and bool(args.out
                                                               or args.gif),
                                 gif_path=args.gif)
        if args.gif:
            print(f"wrote {args.gif}")
        med = sorted(times)[len(times) // 2]
        print(f"{args.animate} frames, median {med * 1e3:.2f} ms/frame "
              f"(sustained; incl. per-frame queue rebuild AND full-frame "
              f"host readback — see app/animate.py)")
        return 0

    exp = build_experiment(args.experiment, args)
    if args.load_state:
        from ..core.checkpoint import load_state

        state = load_state(args.load_state, exp)
        print(f"resumed from {args.load_state}")
    elif args.experiment == "gol" and args.grid:
        state = exp.init(n=args.grid,
                         steps_per_frame=args.steps_per_frame or 1)
    else:
        state = exp.init()
        if args.experiment == "gol" and args.steps_per_frame:
            state.steps_per_frame = args.steps_per_frame
    for k in args.keys:
        state = exp.handle_key(state, k)

    w = h = args.size
    import inspect

    takes_tick = "tick" in inspect.signature(exp.render).parameters
    gif_frames = [] if args.gif else None
    t_start = time.perf_counter()
    for i in range(args.frames):
        tick = i * args.ticks_per_frame
        state = exp.step(state)
        fb = exp.render(state, w, h, tick) if takes_tick else exp.render(state, w, h)
        if args.overlay:
            from ..core.font import draw_text

            fb = draw_text(fb, exp.status(state))
        if args.out or gif_frames is not None:
            from ..core.framebuffer import to_rgb8_topleft, write_png

            if args.out:
                path = f"{args.out}_{i:03d}.png"
                write_png(path, to_rgb8_topleft(fb))
                print(f"wrote {path}")
            if gif_frames is not None:
                gif_frames.append(to_rgb8_topleft(fb))
        print(f"[{i}] {exp.status(state)}")
    dt = time.perf_counter() - t_start
    print(f"{args.frames} frames in {dt:.3f}s ({args.frames / dt:.1f} FPS)")
    if gif_frames:
        from ..core.gif import write_gif

        write_gif(args.gif, gif_frames,
                  fps=min(30.0, max(2.0, args.frames / max(dt, 1e-3))))
        print(f"wrote {args.gif}")
    if args.save_state:
        from ..core.checkpoint import save_state

        written = save_state(args.save_state, state)
        print(f"saved state to {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
