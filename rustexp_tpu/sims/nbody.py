"""Gravitational N-body experiment.

Reference: rs-src/nbody.rs (sim + render), hs-src/RustNBodyExperiment.hs
(driver: defaults N=10,000 stable orbits, dt=0.01, theta=0.85,
RustNBodyExperiment.hs:42-48).

State is (px, py, vx, vy, m) f32 arrays — a pytree threaded through jitted
steps, replacing the reference's Mutex<Vec<Particle>> global (nbody.rs:28-32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.timing import FrameTimes
from ..ops import nbody_forces

# Viewport over the simulation (nbody.rs:13-15)
VP_WDH = 100.0
VP_ORG_X = 0.0
VP_ORG_Y = 0.0


# ---------------------------------------------------------------------------
# Initial conditions (nbody.rs:39-104). Same distributions, JAX PRNG.
# ---------------------------------------------------------------------------


def random_disk(key, n: int):
    """Uniform disk of radius 23, vel in ±3.5, mass in 0.1–1.5 (nbody.rs:40-64)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = jax.random.uniform(k1, (n,))
    v = jax.random.uniform(k2, (n,))
    r = jnp.sqrt(u) * 23.0
    theta = 2.0 * math.pi * v
    px = r * jnp.cos(theta)
    py = r * jnp.sin(theta)
    vel = jax.random.uniform(k3, (n, 2), minval=-3.5, maxval=3.5)
    m = jax.random.uniform(k4, (n,), minval=0.1, maxval=1.5)
    return px, py, vel[:, 0], vel[:, 1], m


def stable_orbits(key, n: int, rmin: float = 0.5, rmax: float = 30.0):
    """Sun (mass 1000) + circular-orbit planets (mass 1), v = sqrt(G*M)
    (nbody.rs:74-104)."""
    sun_mass, planet_mass, g = 1000.0, 1.0, 1.0
    speed = math.sqrt(g * sun_mass)
    k1, k2 = jax.random.split(key)
    r = jax.random.uniform(k1, (n - 1,)) * (rmax - rmin) + rmin
    theta = 2.0 * math.pi * jax.random.uniform(k2, (n - 1,))
    px = jnp.concatenate([jnp.zeros(1), r * jnp.cos(theta)])
    py = jnp.concatenate([jnp.zeros(1), r * jnp.sin(theta)])
    vx = jnp.concatenate([jnp.zeros(1), -speed * jnp.sin(theta)])
    vy = jnp.concatenate([jnp.zeros(1), speed * jnp.cos(theta)])
    m = jnp.concatenate([jnp.full(1, sun_mass), jnp.full(n - 1, planet_mass)])
    return px, py, vx, vy, m


# ---------------------------------------------------------------------------
# Render (nb_draw, nbody.rs:482-583): alpha-blended splat + velocity tail.
# ---------------------------------------------------------------------------

# Golden body/tail colors (nbody.rs:520-521): rgb(255,215,130) x 0.3 / 0.25
_BODY = (76, 64, 39)   # r, g, b after factor 0.3 and truncation
_TAIL = (63, 53, 32)   # after factor 0.25

# Octant direction table (nbody.rs:543-552): E NE N NW W SW S SE.
# Kept as numpy: a module-level jnp array would initialize the JAX
# backend at import time, before the entry point configures JAX (compile
# cache, platform); jnp lifts it on first trace.
_DIRS = np.asarray(
    [[1, 0], [1, 1], [0, 1], [-1, 1], [-1, 0], [-1, -1], [0, -1], [1, -1]],
    dtype=np.int32,
)


@partial(jax.jit, static_argnums=(4, 5))
def nbody_render(px, py, vx, vy, w: int, h: int):
    """uint32[h, w] ABGR frame: saturating-add splats + center cross."""
    aspect = h / w
    x1 = VP_ORG_X - VP_WDH / 2.0
    y1 = (VP_ORG_Y - VP_WDH / 2.0) * aspect
    x2 = VP_ORG_X + VP_WDH / 2.0
    y2 = (VP_ORG_Y + VP_WDH / 2.0) * aspect
    scalex = (1.0 / (x2 - x1)) * w
    scaley = (1.0 / (y2 - y1)) * h

    x = (px - x1) * scalex
    y = (py - y1) * scaley
    xi = x.astype(jnp.int32)  # truncation toward zero, like Rust `as i32`
    yi = y.astype(jnp.int32)

    # tail offset from velocity octant (nbody.rs:540-554)
    angle = jnp.arctan2(vy, vx)
    octant = ((8.0 * angle / (2.0 * math.pi) + 8.0).astype(jnp.int32)) % 8
    d = jnp.asarray(_DIRS)[octant]
    xt = xi - d[:, 0]
    yt = yi - d[:, 1]

    # Saturating sequential adds of non-negative colors == sum-then-clip.
    def splat(acc_rgb, xs, ys, rgb):
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        flat = jnp.where(ok, ys * w + xs, 0)
        weights = ok.astype(jnp.int32)
        out = []
        for ch, val in zip(range(3), rgb):
            out.append(acc_rgb[ch].at[flat].add(weights * val, mode="drop"))
        return out

    acc = [jnp.zeros(h * w, jnp.int32) for _ in range(3)]
    acc = splat(acc, xi, yi, _BODY)
    acc = splat(acc, xt, yt, _TAIL)
    r = jnp.minimum(acc[0], 255).astype(jnp.uint32).reshape(h, w)
    g = jnp.minimum(acc[1], 255).astype(jnp.uint32).reshape(h, w)
    b = jnp.minimum(acc[2], 255).astype(jnp.uint32).reshape(h, w)
    fb = r | (g << 8) | (b << 16)

    # center cross, magenta 0x00FF00FF (nbody.rs:570-577)
    cross = jnp.asarray([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], dtype=jnp.int32)
    fb = fb.at[h // 2 + cross[:, 1], w // 2 + cross[:, 0]].set(jnp.uint32(0x00FF00FF))
    return fb


# ---------------------------------------------------------------------------
# Experiment driver
# ---------------------------------------------------------------------------


@dataclass
class NBodyState:
    px: Any
    py: Any
    vx: Any
    vy: Any
    m: Any
    dt: float = 0.01
    theta: float = 0.85            # 0 -> brute force (reference semantics)
    steps: int = 0
    step_times: FrameTimes = field(default_factory=FrameTimes)
    key: Any = None
    overflow: int = 0
    # Async theta replan (ROADMAP "key-driven theta replan feedback"):
    # an a/A press whose K(theta) needs a not-yet-compiled step program
    # parks the new theta here; step() keeps integrating at the current
    # theta, status() shows "compiling th=...", and the switch lands the
    # step the Prewarmer finishes. None = no replan in flight.
    pending_theta: float | None = None
    prewarm: Any = None

    @property
    def n(self) -> int:
        return int(self.px.shape[0])


class NBodyExperiment:
    name = "NBody"

    def __init__(self, prewarm: bool = False):
        # prewarm=True attaches a core.prewarm.Prewarmer so a/A theta
        # replans whose K(theta) changes the static near-set width
        # compile in the background instead of stalling the sim loop
        # (the reference's interpreted quadtree replans instantly,
        # nbody.rs:197-200; our XLA step is a distinct program per K).
        self._prewarm = prewarm

    def init(self, mode: str = "orbits", n: int = 10_000, rmin: float = 0.5,
             rmax: float = 30.0, seed: int = 0, dt: float = 0.01,
             theta: float = 0.85):
        """Defaults per reference driver (RustNBodyExperiment.hs:42-48)."""
        key = jax.random.PRNGKey(seed)
        key, sub = jax.random.split(key)
        if mode == "disk":
            px, py, vx, vy, m = random_disk(sub, n)
        else:
            px, py, vx, vy, m = stable_orbits(sub, n, rmin, rmax)
        st = NBodyState(px=px, py=py, vx=vx, vy=vy, m=m, dt=dt, theta=theta,
                        key=key)
        if self._prewarm:
            from ..core.prewarm import Prewarmer

            st.prewarm = Prewarmer(self._warm_cfg)
        return st

    # Block-size preference for the approximate path: largest divisor of N
    # from this tuple keeps blocks big enough for meaningful monopoles and
    # small enough for near-field pair tiles. N with no divisor here (e.g.
    # primes like 2047) takes the exact route — documented, tested policy
    # instead of silent fallthrough.
    BH_BLOCKS = (256, 200, 128, 125, 100, 64, 50, 32, 25)
    BH_MIN_N = 2048  # below this brute force is faster than sort+aggregate

    def select_backend(self, n: int, theta: float) -> tuple:
        """Explicit step-routing policy -> ("brute"|"bh", block or None).

        * theta == 0 -> brute force, the reference's own contract
          (nbody.rs:197-200).
        * n < BH_MIN_N or no usable block divisor -> brute force.
        * otherwise -> block Barnes-Hut (ops/nbody_bh.py) with
          K(theta) exact nearest blocks.
        """
        block = next((b for b in self.BH_BLOCKS
                      if n % b == 0 and n // b > 4), None)
        if theta == 0.0 or n < self.BH_MIN_N or block is None:
            return "brute", None
        return "bh", block

    def _step_cfg(self, n: int, theta: float) -> tuple:
        """The static-program key of step(): one XLA program per cfg.

        Mirrors step()'s routing exactly — backend choice, force-kernel
        eligibility, and K(theta) (the static near-set width). dt is a
        traced scalar and so not part of the key.
        """
        from ..ops import nbody_pallas

        backend, block = self.select_backend(n, theta)
        if backend == "brute":
            return ("brute_pallas" if nbody_pallas.supported(n) else "brute",
                    0, 0, n)
        from ..ops import nbody_bh

        k = nbody_bh.theta_to_k(theta, n // block)
        return ("bh", block, k, n)

    @staticmethod
    def _warm_cfg(cfg: tuple, tick: float) -> None:
        """Compile the step program `cfg` names (dummy state, discarded)."""
        backend, block, k, n = cfg
        z, ones = jnp.zeros(n, jnp.float32), jnp.ones(n, jnp.float32)
        if backend == "brute_pallas":
            from ..ops import nbody_pallas

            out = nbody_pallas.step_brute_pallas(z, z, z, z, ones, 0.01)
        elif backend == "brute":
            out = nbody_forces.step_brute_force(z, z, z, z, ones, 0, 0.01)
        else:
            from ..ops import nbody_bh

            out = nbody_bh.step_bh(z, z, z, z, ones, block, k, 0.01)
        jax.block_until_ready(out)

    def step(self, state: NBodyState) -> NBodyState:
        import time

        if state.prewarm is not None and state.pending_theta is not None:
            pcfg = self._step_cfg(state.n, state.pending_theta)
            if state.prewarm.is_warm(pcfg):
                state.theta = state.pending_theta
                state.pending_theta = None
                self._trace_replan(state)
            else:
                state.prewarm.request(pcfg, 0.0, urgent=True)
        t0 = time.perf_counter()
        backend, block = self.select_backend(state.n, state.theta)
        if backend == "brute":
            from ..ops import nbody_pallas

            if nbody_pallas.supported(state.n):
                px, py, vx, vy = nbody_pallas.step_brute_pallas(
                    state.px, state.py, state.vx, state.vy, state.m,
                    state.dt,
                )
            else:
                px, py, vx, vy = nbody_forces.step_brute_force(
                    state.px, state.py, state.vx, state.vy, state.m, 0, state.dt
                )
        else:
            from ..ops import nbody_bh

            k = nbody_bh.theta_to_k(state.theta, state.n // block)
            px, py, vx, vy, m = nbody_bh.step_bh(
                state.px, state.py, state.vx, state.vy, state.m,
                block, k, state.dt,
            )
            state.m = m  # the BH step returns a permuted particle set
        px.block_until_ready()
        state.px, state.py, state.vx, state.vy = px, py, vx, vy
        state.steps += 1
        state.step_times.push(time.perf_counter() - t0)
        if state.prewarm is not None:
            # stepping IS the warm-up for the current program
            state.prewarm.mark_warm(self._step_cfg(state.n, state.theta))
        return state

    def render(self, state: NBodyState, w: int, h: int):
        return nbody_render(state.px, state.py, state.vx, state.vy, w, h)

    def status(self, state: NBodyState) -> str:
        _, med, _, _ = state.step_times.stats()
        sps = 1.0 / med if med > 0 else 0.0
        backend, _ = self.select_backend(state.n, state.theta)
        algo = "brute" if backend == "brute" else f"bh(th={state.theta:.2f})"
        s = (
            f"{state.steps} Steps, SPS: {sps:.0f}, {med * 1000:.2f}ms, "
            f"{state.n} Bodies, dt {state.dt}, {algo}"
        )
        if state.pending_theta is not None:
            s = f"compiling th={state.pending_theta:.2f}... | " + s
        return s

    def _trace_replan(self, state: NBodyState) -> None:
        """Announce the routing/K consequence of a theta change — a K(theta)
        change means the next step recompiles the BH kernel (new static
        near-set width), which would otherwise look like a silent stall."""
        from ..core.trace import trace_info

        backend, block = self.select_backend(state.n, state.theta)
        if backend == "brute":
            trace_info(f"theta={state.theta:.2f}: routing to brute force")
        else:
            from ..ops import nbody_bh

            k = nbody_bh.theta_to_k(state.theta, state.n // block)
            trace_info(f"theta={state.theta:.2f}: block-BH K={k} exact "
                       f"near blocks (recompiles on first step if K changed)")

    def _apply_theta(self, state: NBodyState, new_theta: float) -> NBodyState:
        """Apply a theta change, deferring it when a recompile is due.

        Without a Prewarmer (bench/headless), or when the new theta maps
        to the SAME step program (K(theta) often survives a 0.05 nudge)
        or an already-warm one, the switch is immediate — the reference's
        behavior (RustNBodyExperiment.hs:91-94). Otherwise the theta goes
        pending: step() keeps integrating at the current theta, the new
        program compiles urgently on the warm thread, and the replan
        lands the step it is ready (the async answer established for the
        rasterizer's config switches — ROADMAP "theta replan feedback").
        """
        cfg = self._step_cfg(state.n, new_theta)
        if (state.prewarm is None
                or cfg == self._step_cfg(state.n, state.theta)
                or state.prewarm.is_warm(cfg)):
            state.theta = new_theta
            state.pending_theta = None
            self._trace_replan(state)
            return state
        from ..core.trace import trace_info

        state.pending_theta = new_theta
        state.prewarm.request(cfg, 0.0, urgent=True)
        trace_info(f"theta={new_theta:.2f}: new step program {cfg[:3]} — "
                   "compiling in background, replan lands when ready")
        return state

    def handle_key(self, state: NBodyState, key: str) -> NBodyState:
        """Keys per reference RustNBodyExperiment.hs:81-98.

        The reset keys are shift-insensitive like the reference's GLFW
        Key'Q/W/E matches; only dt (x/X) and theta (a/A) use case to pick
        the direction, which is why the viewer feeds raw keys here.
        """
        state.key, sub = jax.random.split(state.key)
        if key in ("Q", "q"):
            st = self.init(mode="orbits", n=10_000)
        elif key in ("W", "w"):
            st = self.init(mode="disk", n=10_000)
        elif key in ("E", "e"):
            st = self.init(mode="orbits", n=5, rmin=5.0, rmax=30.0)
        elif key == "X":
            state.dt *= 2.0
            return state
        elif key == "x":
            state.dt /= 2.0
            return state
        elif key in ("A", "a"):
            # Repeated presses while a replan is compiling step from the
            # PENDING theta (rasterizer handle_key's base() rule).
            cur = (state.pending_theta if state.pending_theta is not None
                   else state.theta)
            new = (min(0.95, cur + 0.05) if key == "A"
                   else max(0.0, cur - 0.05))
            return self._apply_theta(state, new)
        else:
            return state
        st.dt, st.theta = state.dt, state.theta
        if state.prewarm is not None:
            # carry the warm thread (and its warmed-set) across resets —
            # the jit caches it fronts are process-wide anyway
            st.prewarm = state.prewarm
        return st
