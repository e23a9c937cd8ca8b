"""Game of Life experiment.

Reference: rs-src/gol.rs (sim + render) and hs-src/RustGoLExperiment.hs
(driver). The reference decouples sim and render with a free-running worker
thread serialized by an MVar (RustGoLExperiment.hs:43-65,96-108); here BOTH
analogs exist: `steps_per_frame` generations fuse into one on-device
dispatch per rendered frame, and the viewer runs the experiment in a
free-running SimWorker thread (`decoupled = True` below; app/viewer.py)
whose lock plays the MVar's role.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..assets.gol_patterns import PATTERNS, pattern_to_array
from ..core.timing import FrameTimes
from ..ops import gol_bits, gol_stencil

GRID_WDH = gol_stencil.GRID_WDH


def randomize(key, n: int = GRID_WDH) -> jax.Array:
    """Uniform random fill (reference gol_randomize, gol.rs:18-29)."""
    return jax.random.bernoulli(key, 0.5, (n, n)).astype(jnp.uint8)


def set_pattern(pattern: np.ndarray, n: int = GRID_WDH) -> jax.Array:
    """Center `pattern` on an empty grid (reference gol_set_pattern,
    gol.rs:200-225). The grid size is a config knob here — the reference
    hardcodes 256 at compile time (gol.rs:8)."""
    h, w = pattern.shape
    grid = np.zeros((n, n), dtype=np.uint8)
    xoffs = n // 2 - w // 2
    yoffs = n // 2 - h // 2
    ys, xs = np.nonzero(pattern)
    gy, gx = ys + yoffs, xs + xoffs
    keep = (gy >= 0) & (gy < n) & (gx >= 0) & (gx < n)
    grid[gy[keep], gx[keep]] = 1
    return jnp.asarray(grid)


@jax.jit
def gol_render(grid, w_arr, h_arr):
    """Render grid centered into a [h,w] ABGR32 fb (reference gol_draw, gol.rs:172-198).

    Background bytes = 64 -> 0x40404040; alive = 0x00FFFFFF, dead = 0.
    """
    h, w = h_arr.shape[0], w_arr.shape[0]
    n = grid.shape[0]
    fb = jnp.full((h, w), jnp.uint32(0x40404040))
    cell = jnp.where(grid.astype(jnp.uint32) == 1, jnp.uint32(0x00FFFFFF), jnp.uint32(0))
    xoffs = w // 2 - n // 2
    yoffs = h // 2 - n // 2
    if w >= n and h >= n:
        return jax.lax.dynamic_update_slice(fb, cell, (yoffs, xoffs))
    # Small-fb fallback: clip the centered blit (reference skips OOB pixels)
    ys = jnp.arange(h)[:, None] - yoffs
    xs = jnp.arange(w)[None, :] - xoffs
    inside = (ys >= 0) & (ys < n) & (xs >= 0) & (xs < n)
    vals = cell[jnp.clip(ys, 0, n - 1), jnp.clip(xs, 0, n - 1)]
    return jnp.where(inside, vals, fb)


@dataclass
class GoLState:
    grid: Any
    generations: int = 0
    steps_per_frame: int = 1
    backend: str = "auto"
    step_times: FrameTimes = field(default_factory=FrameTimes)
    key: Any = None


class GoLExperiment:
    decoupled = True  # viewer runs the sim in a free-running worker thread
    name = "GoL"

    def init(self, pattern: str = "ark", seed: int = 0, steps_per_frame: int = 1,
             n: int = GRID_WDH,
             backend: str = "auto"):
        """Initial pattern 'ark' matches the reference (RustGoLExperiment.hs:54).

        backend "auto" picks the SWAR bit-packed form (ops/gol_bits.py)
        when the grid's rows are a multiple of 32, else the circulant
        matmul form — all backends are bit-identical, only throughput
        differs."""
        key = jax.random.PRNGKey(seed)
        grid = set_pattern(pattern_to_array(PATTERNS[pattern]), n)
        return GoLState(grid=grid, steps_per_frame=steps_per_frame, backend=backend, key=key)

    def step(self, state: GoLState) -> GoLState:
        import time

        t0 = time.perf_counter()
        k = state.steps_per_frame
        backend = state.backend
        if backend == "auto":
            backend = ("bits" if state.grid.shape[0] % gol_bits.BITS == 0
                       else "mxu")
        if backend == "bits":
            state.grid = gol_bits.multi_step_swar(state.grid, k)
        else:
            state.grid = gol_stencil.multi_step(state.grid, k, backend)
        state.grid.block_until_ready()
        state.step_times.push((time.perf_counter() - t0) / max(k, 1))
        state.generations += k
        return state

    def render(self, state: GoLState, w: int, h: int):
        return gol_render(state.grid, jnp.zeros(w), jnp.zeros(h))

    def status(self, state: GoLState) -> str:
        _, med, _, _ = state.step_times.stats()
        gps = 1.0 / med if med > 0 else 0.0
        n = state.grid.shape[0]
        return (
            f"{n}x{n} Grid, {state.generations} Gens, "
            f"{med * 1000:.2f}ms, GPS: {gps:.0f}, x{state.steps_per_frame} | "
            f"[R]nd [G]un [A]corn [F]ill ar[K] [T/Y]steps"
        )

    def handle_key(self, state: GoLState, key: str) -> GoLState:
        """Keybindings per reference RustGoLExperiment.hs:78-91.

        The reference's T/Shift-T pair steps its thread count 1-16; the
        analog knob here is steps_per_frame (generations fused per
        dispatch). A raw terminal delivers single chars with no modifier
        state and lowercase 't' is the viewer's global screenshot key
        (App.hs:60-62), so the pair is T = double / Y = halve (adjacent
        key, case-folded like the other bindings).
        """
        key = key.upper() if len(key) == 1 else key
        n = int(state.grid.shape[0])
        if key == "R":
            state.key, sub = jax.random.split(state.key)
            state.grid = randomize(sub, n)
            state.generations = 0
        elif key in ("G", "A", "F", "K"):
            name = {"G": "gun", "A": "acorn", "F": "spacefill", "K": "ark"}[key]
            state.grid = set_pattern(pattern_to_array(PATTERNS[name]), n)
            state.generations = 0
        elif key == "T":
            state.steps_per_frame = min(64, state.steps_per_frame * 2)
        elif key == "Y":
            state.steps_per_frame = max(1, state.steps_per_frame // 2)
        return state
