"""Game of Life torus-stencil kernels.

Reference semantics: gol_step, rs-src/gol.rs:31-170 — 8-neighbor sum with
torus wrap, rule ``alive_nb == 3 || (alive && alive_nb == 2)`` (gol.rs:79).

The reference splits the grid into border strips + per-thread interior
strips; here the whole grid is one array op. Two plain-XLA forms:

  * step_roll   — 8 circular shifts + rule; the readable oracle.
  * step_mxu    — the 3x3 neighbor sum as two circulant matmuls:
                  nb = A @ G @ A^T - G, A = circulant(1,1,1).
  * multi_step  — K generations fused in one dispatch (lax.fori_loop under
                  jit), the analog of the reference's free-running sim worker
                  thread (hs-src/RustGoLExperiment.hs:96-108).

The production path is the bit-packed form in ops/gol_bits.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax

GRID_WDH = 256  # reference gol.rs:8


def step_roll(grid):
    """One generation; grid is int-typed [h, w] of {0,1}. Torus wrap."""
    g = grid.astype(jnp.int32)
    nb = (
        jnp.roll(g, 1, 0) + jnp.roll(g, -1, 0) + jnp.roll(g, 1, 1) + jnp.roll(g, -1, 1)
        + jnp.roll(jnp.roll(g, 1, 0), 1, 1) + jnp.roll(jnp.roll(g, 1, 0), -1, 1)
        + jnp.roll(jnp.roll(g, -1, 0), 1, 1) + jnp.roll(jnp.roll(g, -1, 0), -1, 1)
    )
    return _rule(g, nb).astype(grid.dtype)


def _rule(alive, nb):
    return ((nb == 3) | ((alive == 1) & (nb == 2))).astype(jnp.int32)


@lru_cache(maxsize=8)
def _circulant_111_np(n: int):
    """Circulant matrix I + shift(+1) + shift(-1): row i has ones at i-1,i,i+1 (mod n)."""
    import numpy as np

    a = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n)
    a[idx, idx] = 1.0
    a[idx, (idx + 1) % n] = 1.0
    a[idx, (idx - 1) % n] = 1.0
    return a


def _circulant_111(n: int, dtype_name: str):
    # NOTE: the cache must hold host data, never traced arrays — converting
    # per call keeps it a compile-time constant under jit.
    return jnp.asarray(_circulant_111_np(n), dtype=jnp.dtype(dtype_name))


def step_mxu(grid, dtype=jnp.float32):
    """One generation with the neighbor sum as two matmuls.

    A @ G sums each cell's vertical 3-neighborhood; (A @ G) @ A^T then sums
    horizontally — the full 3x3 box. Subtract G to get the 8-neighbor count.
    Counts are <= 9, so every precision is exact, bf16 and TF32 included.
    """
    n = grid.shape[0]
    assert grid.shape == (n, n)
    a = _circulant_111(n, jnp.dtype(dtype).name)
    g = grid.astype(dtype)
    box = jnp.dot(jnp.dot(a, g, preferred_element_type=dtype), a.T,
                  preferred_element_type=dtype)
    nb = (box - g).astype(jnp.int32)
    return _rule(grid.astype(jnp.int32), nb).astype(grid.dtype)


@partial(jax.jit, static_argnums=(1, 2))
def multi_step(grid, k: int, backend: str = "mxu"):
    """Advance k generations in one dispatch."""
    step = step_mxu if backend == "mxu" else step_roll
    return lax.fori_loop(0, k, lambda i, g: step(g), grid)
