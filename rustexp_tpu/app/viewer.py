"""Interactive terminal viewer — the engine's "window".

Replaces the reference's GLFW/OpenGL shell (hs-src/Main.hs:48-76,
App.hs:155-215) with an ANSI truecolor terminal renderer: each character
cell shows two framebuffer pixels via the upper-half-block glyph, the
status bar mirrors the reference's overlay (App.hs:106-129), and the
reference's keybindings work unchanged:

  global:  - / =  switch experiment (App.hs:65-66)   ESC quit
           t      screenshot PNG    (App.hs:60-62)
  GoL:     r randomize, g gun, a acorn, f spacefill, k ark,
           T/Y steps-per-frame up/down (threads analog)
  N-body:  q orbits-10k, w disk-10k, e orbits-5, x/X dt, a/A theta
  Raster:  m mode, p per-pixel, q/w mesh, a/s shader, z/x envmap, 1/2 bg,
           b benchmark

Run:  python -m rustexp_tpu.app.viewer [--size 192] [--fps 30]
"""

from __future__ import annotations

import argparse
import select
import sys
import time

import numpy as np


def fb_to_ansi(rgb: np.ndarray) -> str:
    """uint8 RGB [h, w, 3] (top-left origin, even h) -> ANSI half-block rows.

    Prefers the native C++ pump (rx_ansi_frame: ~60x faster than this
    Python loop at 512^2, with run-length color dedup); this loop is the
    always-available fallback and the test oracle.
    """
    from .. import native

    if native.available():
        out = native.ansi_frame(rgb)
        if out is not None:
            return out
    return fb_to_ansi_py(rgb)


def fb_to_ansi_py(rgb: np.ndarray) -> str:
    h, w, _ = rgb.shape
    top = rgb[0 : h - 1 : 2].astype(np.uint32)
    bot = rgb[1:h:2].astype(np.uint32)
    rows = []
    for y in range(top.shape[0]):
        t, b = top[y], bot[y]
        cells = [
            f"\x1b[38;2;{t[x,0]};{t[x,1]};{t[x,2]}m"
            f"\x1b[48;2;{b[x,0]};{b[x,1]};{b[x,2]}m▀"
            for x in range(w)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def _experiments():
    from ..sims.gol import GoLExperiment
    from ..sims.nbody import NBodyExperiment
    from ..sims.rasterizer import RasterizerExperiment

    # prewarm=True: the rasterizer background-compiles neighbor configs
    # so q/w/a/s/... switches land warm (async "compiling..." otherwise);
    # the N-body driver defers a/A theta replans whose K(theta) needs a
    # new step program the same way (status shows "compiling th=...")
    return [GoLExperiment(), NBodyExperiment(prewarm=True),
            RasterizerExperiment(prewarm=True)]


class SimWorker:
    """Free-running sim thread — the reference's golWorker + MVar pattern
    (RustGoLExperiment.hs:43-65, 96-108): a dedicated thread steps the
    simulation as fast as the device allows while the render loop displays
    the latest published state. The lock serializes step/read/key exactly
    like the reference's MVar serializes Rust access; JAX dispatch releases
    the GIL during device execution, so sim and ANSI presentation genuinely
    overlap."""

    def __init__(self, exp, state):
        import threading

        self.exp = exp
        self._lock = threading.Lock()
        self._state = state
        self._stop = threading.Event()
        self._running = threading.Event()
        self._running.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self._running.wait(timeout=0.5)
            if not self._running.is_set():
                continue  # paused: the current experiment owns the device
            with self._lock:
                self._state = self.exp.step(self._state)
            # Python locks are unfair: without a yield, the tight
            # release/reacquire can starve the render thread's read()/key()
            # for many iterations (a frame-rate collapse on few-core
            # hosts). One ms costs the sim <5% at real step durations.
            time.sleep(0.001)

    def read(self):
        """Immutable snapshot of the latest published state: a shallow
        dataclass copy taken under the lock. Field values are jax arrays
        (immutable), so the copy can be read at leisure while the worker
        keeps rebinding fields on its own instance — no torn reads."""
        import copy

        with self._lock:
            return copy.copy(self._state)

    def key(self, k):
        with self._lock:
            self._state = self.exp.handle_key(self._state, k)

    def pause(self):
        """Stop stepping (keeps state) — called when the viewer switches
        away, so a background sim never contends for device dispatch with
        the active experiment."""
        self._running.clear()

    def resume(self):
        self._running.set()

    def stop(self):
        self._stop.set()
        self._running.set()
        self._thread.join(timeout=5)


class _RawTerm:
    """Raw, non-blocking stdin for key polling; restores settings on exit.

    When stdin is not a tty (piped/redirected, e.g. a headless --frames
    run under a harness), key polling degrades to a no-op instead of
    dying in tcgetattr with "Inappropriate ioctl for device".
    """

    def __enter__(self):
        self.tty = sys.stdin.isatty()
        if self.tty:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        if self.tty:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def poll_key(self):
        if not self.tty:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None


def run_viewer(size: int = 192, fps: float = 30.0, frames: int | None = None,
               start: int = 2, vsync: bool = True,
               inject_every: tuple[int, str] | None = None,
               report: bool = False):
    """Main loop (App.hs:196-214): tick, events, draw, present.

    Headless measurement (VERDICT r3 next-5): ``report=True`` prints one
    JSON line with the sustained loop stats (the same 60-ring the header
    shows, first 3 frames dropped) to stderr at exit;
    ``inject_every=(K, ch)`` feeds key ``ch`` through the real key path
    every K frames and records keypress-to-presented-frame latency.
    """
    from ..core.framebuffer import to_rgb8_topleft, write_png

    exps = _experiments()
    cur = start  # the reference starts on the rasterizer (App.hs:163)
    states = [None] * len(exps)
    workers = [None] * len(exps)  # free-running sims (GoL: decoupled=True)
    t0 = time.perf_counter()
    frame = 0
    shot = 0

    def ensure(i):
        if states[i] is None:
            states[i] = exps[i].init()
        if workers[i] is None and getattr(exps[i], "decoupled", False):
            workers[i] = SimWorker(exps[i], states[i])
        elif workers[i] is not None:
            workers[i].resume()
        return workers[i]

    def switch(to):
        # Pause the outgoing experiment's free-runner so it stops
        # contending for device dispatch (resumed by ensure() on return).
        if workers[cur] is not None:
            workers[cur].pause()
        return to % len(exps)

    sys.stdout.write("\x1b[2J")  # clear once
    esc_armed = False  # double-ESC guard against accidental exit (App.hs:53-59)
    # vsync: 'v' toggles the frame-rate cap (App.hs:63: vsync key)
    key_lat: list[float] = []  # keypress -> presented-frame latencies
    # Global FPS header over a 60-deep ring, first 3 frames dropped as
    # compile-warmup outliers (reference App.hs:135-150, 211).
    from ..core.timing import FrameTimes, median

    ftimes = FrameTimes(limit=60)
    t_prev = time.perf_counter()
    with _RawTerm() as term:
        while frames is None or frame < frames:
            tick = time.perf_counter() - t0

            key = term.poll_key()
            t_key = None
            if key is None and inject_every and frame >= 3 \
                    and frame % inject_every[0] == 0:
                key = inject_every[1]
                t_key = time.perf_counter()
            if key == "\x1b":
                if esc_armed:  # second consecutive ESC exits
                    break
                esc_armed = True
            elif key:
                esc_armed = False
            if key == "\x1b":
                pass
            elif key == "=":
                cur = switch(cur + 1)
            elif key == "-":
                cur = switch(cur - 1)
            elif key == "v":
                vsync = not vsync
            elif key and key != "t":  # 't' screenshots below, after render
                w_ = ensure(cur)
                # Raw key: N-body's x/X and a/A bindings are case-sensitive
                if w_ is not None:
                    w_.key(key)
                else:
                    states[cur] = exps[cur].handle_key(states[cur], key)

            exp = exps[cur]
            worker = ensure(cur)
            if worker is not None:
                # decoupled: read the free-running sim's latest state
                states[cur] = worker.read()
            else:
                states[cur] = exp.step(states[cur])
            import inspect

            if "tick" in inspect.signature(exp.render).parameters:
                fb = exp.render(states[cur], size, size, tick)
            else:
                fb = exp.render(states[cur], size, size)
            rgb = to_rgb8_topleft(fb)
            if key == "t":
                path = f"rustexp_shot_{shot:03d}.png"
                write_png(path, rgb)
                shot += 1

            t_now = time.perf_counter()
            if frame >= 3:
                ftimes.push(t_now - t_prev)
            t_prev = t_now
            head = f"{ftimes.status_string()} | " if ftimes.times else ""
            status = f"{head}[{exp.name}] {exp.status(states[cur])}"
            if esc_armed:
                status = "ESC again to exit | " + status
            if not vsync:
                status = "VSYNC OFF | " + status
            status = status[: size - 1]
            sys.stdout.write("\x1b[H" + fb_to_ansi(rgb) + "\n\x1b[K" + status)
            sys.stdout.flush()
            if t_key is not None:
                key_lat.append(time.perf_counter() - t_key)

            frame += 1
            budget = frame / fps - (time.perf_counter() - t0)
            if vsync and budget > 0:
                time.sleep(budget)
    for w_ in workers:
        if w_ is not None:
            w_.stop()
    sys.stdout.write("\x1b[0m\n")
    if report:
        import json

        fps_, med, lo, hi = ftimes.stats()
        rec = {
            "experiment": exps[cur].name,
            "size": size,
            "frames": frame,
            "vsync": vsync,
            "fps_median": round(fps_, 2),
            "frame_ms_median": round(med * 1e3, 3),
            "frame_ms_best": round(lo * 1e3, 3),
            "frame_ms_worst": round(hi * 1e3, 3),
        }
        if key_lat:
            rec["key_to_frame_ms_median"] = round(median(key_lat) * 1e3, 3)
            rec["key_to_frame_ms_worst"] = round(max(key_lat) * 1e3, 3)
            rec["keys_injected"] = len(key_lat)
        print(json.dumps(rec), file=sys.stderr)
    return frame


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=192,
                   help="square framebuffer edge (terminal needs size x size/2 cells)")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until q/ESC)")
    p.add_argument("--start", type=int, default=2,
                   help="starting experiment index (0 GoL, 1 NBody, 2 Raster)")
    p.add_argument("--no-vsync", action="store_true",
                   help="uncapped loop (the 'v' toggle, pre-toggled)")
    p.add_argument("--report", action="store_true",
                   help="print one JSON line of sustained loop stats to "
                        "stderr at exit (60-ring, first 3 frames dropped)")
    p.add_argument("--inject-key", default=None, metavar="K:CH",
                   help="feed key CH through the real key path every K "
                        "frames and record keypress-to-frame latency")
    args = p.parse_args(argv)
    inject = None
    if args.inject_key:
        k, _, ch = args.inject_key.partition(":")
        inject = (max(1, int(k)), ch or " ")

    from ..core.platform import enable_compile_cache

    enable_compile_cache()
    run_viewer(args.size, args.fps, args.frames, args.start,
               vsync=not args.no_vsync, inject_every=inject,
               report=args.report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
