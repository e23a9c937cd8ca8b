"""rustexp_tpu — a GPU simulation & software-rendering engine in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the
blitzcode/rust-exp reference (a Haskell/Rust CPU playground): a software
rasterizer with irradiance-cubemap IBL shading, a gravitational N-body
simulator, a Game of Life cellular automaton, and a sine-scroller demo —
re-designed as array programs:

  * pure step/render functions over explicit state pytrees, `jit`-compiled
  * Pallas kernels for the hot inner loops (stencil, all-pairs forces,
    tile rasterization)
  * multi-chip scaling via `jax.sharding.Mesh` + `shard_map` collectives

Layout (mirrors SURVEY.md §7):
  core/      framebuffer conventions, color packing, gamma LUTs, timing, trace
  assets/    mesh (.dat) / Radiance-HDR / cubemap loaders, GoL pattern library
  ops/       compute kernels (XLA + Pallas)
  sims/      one module per experiment: init/step/render/status functional API
  parallel/  multi-device (Mesh/shard_map) variants of the three hot loops
  app/       CLI driver, PNG output, benchmark harness
  native/    C++ asset-loading runtime (ctypes)
"""

__version__ = "0.1.0"
