"""Sine scroller — the 'hello world' experiment.

Reference: rs-src/sine_scroller.rs:4-17 (kernel) and
hs-src/RustSineExperiment.hs (driver). The reference scans every pixel with
two scalar sin() calls; here the field is separable — one sin per row and
column, then a rank-1 outer product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..core.timing import FrameTimes

_TWO_PI = 2.0 * math.pi


@jax.jit
def sine_frame(w_iota, h_iota, tick):
    """uint32[h,w] grayscale frame. w_iota/h_iota are jnp.arange(w|h) float32.

    Matches sine_scroller.rs:4-17: gray = trunc((sx+1)/2 * (sy+1)/2 * 255),
    pixel = gray | gray<<8 | gray<<16, with sx = sin((x/64 + tick)*2π).
    """
    tick = jnp.float32(tick)
    sx = jnp.sin((w_iota / 64.0 + tick) * _TWO_PI)
    sy = jnp.sin((h_iota / 64.0 + tick) * _TWO_PI)
    gx = (sx + 1.0) * 0.5
    gy = (sy + 1.0) * 0.5
    gray = (gy[:, None] * gx[None, :] * 255.0).astype(jnp.uint32)
    return gray | (gray << 8) | (gray << 16)


@dataclass
class SineState:
    tick: float
    frame_times: FrameTimes


class SineExperiment:
    name = "Rust Sine Scroller"  # display-name parity with the reference list

    def init(self, **config):
        return SineState(tick=0.0, frame_times=FrameTimes())

    def step(self, state: SineState, dt: float = 1.0 / 60.0) -> SineState:
        state.tick += dt
        return state

    def render(self, state: SineState, w: int, h: int):
        return sine_frame(
            jnp.arange(w, dtype=jnp.float32), jnp.arange(h, dtype=jnp.float32), state.tick
        )

    def status(self, state: SineState) -> str:
        _, med, _, _ = state.frame_times.stats()
        return f"{med * 1000.0:.2f}ms"

    def handle_key(self, state: SineState, key: str) -> SineState:
        return state
