#!/usr/bin/env python
"""Time each hand-written kernel against the plain-XLA form it replaces,
on the GPU, at the bench shapes. One JSON line per measurement.

    python tools/kernel_ab.py [raster|tiles|gol|nbody|bh ...]

  raster  end-to-end fixed-eye frames (app/benchmark.bench_scene): the
          queue kernel vs its XLA twin for real meshes, vs the whole-frame
          XLA oracle for the 12-triangle cube
  tiles   the queue kernel alone (FRAMES calls in one scan) at several
          tile shapes and warp counts
  gol     SWAR CUDA kernel vs the plain-XLA SWAR generation (bench_gol),
          and pick_plan's tiling vs other tilings at 256^2
  nbody   brute-force force kernel vs plain XLA (bench_nbody)
  bh      block-BH step with the Morton sort as argsort + one gather per
          array vs one lax.sort carrying the payloads

Run it once with RUSTEXP_STRICT_IEEE=0 to price the f32 seals
(ops/ieee.py): the "strict" field of every line says which mode ran.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FRAMES = 128  # frames per timed dispatch (bench_scene uses 1024)
SIZE = 512    # frame side of the kernel-alone A/B (the bench frame)


def emit(**kw):
    from rustexp_tpu.ops.ieee import strict_default

    print(json.dumps({**kw, "strict": strict_default()}), flush=True)


def raster():
    from rustexp_tpu.app import benchmark as bm

    bm.FRAMES_PER_DISPATCH = FRAMES
    for label, mesh_idx, per_pixel, _ in bm.SCENES:
        if label not in ("KillerooP", "KillerooV", "TorusKnotP", "CubeV",
                         "CubeP"):
            continue
        alts = (("xla", "queue") if mesh_idx == 9
                else ("queue", "queue_xla"))
        for backend in alts + alts[::-1]:
            st = bm.bench_scene(mesh_idx, per_pixel, runs=24,
                                backend=backend, return_stats=True)
            emit(what="raster_frame", scene=label, backend=backend,
                 us_best=st["best"] * 1e6, us_median=st["median"] * 1e6,
                 spread_pct=st["spread_pct"], frames=FRAMES)


def _kernel_scan(n2, n3, h, w, th, tw, warps):
    """FRAMES queue-kernel calls in one jitted scan; the carry feeds a
    zero into the inputs so that no call can be hoisted or shared."""
    import jax
    from jax import lax

    from rustexp_tpu.ops import raster_queue as rq

    @jax.jit
    def run(q, s, e):
        def body(c, _):
            z = rq.raster_attrs_queue(
                q, s, tuple(x + c * 0.0 for x in e), n2, n3, h, w,
                tile_h=th, tile_w=tw, num_warps=warps)[0]
            return c + z[0, 0], None
        return lax.scan(body, 0.0, None, length=FRAMES)[0]
    return run


def tiles():
    import numpy as np

    from rustexp_tpu.app.benchmark import _run_stats
    from rustexp_tpu.ops import raster_queue as rq
    from rustexp_tpu.ops.raster_setup import setup_triangles_planar
    from rustexp_tpu.raster import pipeline as pp
    from chip_smoke import _scene_and_eye

    w = h = SIZE
    for mesh_idx in (0, 6):   # Killeroo stand-in, torus knot
        _, scene, eye = _scene_and_eye(mesh_idx)
        xs, ys, zs, iw, n_c, world_c = pp.transform_corners_planar(
            scene, eye, w, h)
        setup = setup_triangles_planar(xs, ys, zs, w, h)
        extra, n2, n3 = pp.queue_attr_channels(scene, iw, n_c, world_c, None,
                                               True)
        for th, tw in ((16, 128), (16, 64), (8, 128), (32, 64), (32, 128)):
            stats = tuple(int(x) for x in rq.queue_stats(
                setup, h, w, tile_h=th, tile_w=tw))
            s_cap, m_y, m_x, t_cap = rq.suggest_queue_config(stats)
            q = rq.build_queue(setup, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x,
                               t_cap=t_cap, tile_h=th, tile_w=tw,
                               shade_w=min(rq.SHADE_W, tw))
            for warps in (4, 8):
                run = _kernel_scan(n2, n3, h, w, th, tw, warps)
                st = _run_stats(lambda: np.asarray(run(q, setup,
                                                       tuple(extra))),
                                3, FRAMES)
                emit(what="raster_kernel", mesh=mesh_idx, tile=[th, tw],
                     num_warps=warps, us_best=st["best"] * 1e6,
                     us_median=st["median"] * 1e6,
                     pairs=int(np.asarray(q.tiles)[:, 1].sum()))


def gol():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rustexp_tpu.app import benchmark as bm
    from rustexp_tpu.ops import cuda_ffi, gol_bits

    for n in (256, 2048):
        for backend in ("bits", "bits_xla", "bits_xla", "bits"):
            r = bm.bench_gol(generations_per_dispatch=16384, runs=3, n=n,
                             backend=backend)
            emit(what="gol", n=n, backend=backend, cells_per_s=r["value"],
                 gens_per_s=r["gens_per_s"], spread_pct=r["spread_pct"])
    k = 16384
    p = gol_bits.pack_rows(jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (256, 256)).astype(np.int32)))
    for plan in (gol_bits.pick_plan(8, 256, k), gol_bits.Plan(1, 32, 16),
                 gol_bits.Plan(2, 64, 32), gol_bits.Plan(1, 32, 64)):
        f = jax.jit(lambda p, plan=plan: cuda_ffi.gol_swar(p, k, plan))
        jax.block_until_ready(f(p))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f(p))
            ts.append(time.perf_counter() - t0)
        emit(what="gol_plan", n=256, plan=plan._asdict(),
             gens_per_s=k / min(ts))


def nbody():
    from rustexp_tpu.app import benchmark as bm

    for backend in ("pallas", "xla", "xla", "pallas"):
        r = bm.bench_nbody(backend=backend, steps_per_dispatch=4, runs=3)
        emit(what="nbody_brute", backend=backend, steps_per_s=r["value"],
             spread_pct=r["spread_pct"])


def bh():
    import jax
    import jax.numpy as jnp

    from rustexp_tpu.app import benchmark as bm
    from rustexp_tpu.ops import nbody_bh

    argsort_gather = nbody_bh.morton_sort

    def lax_sort(px, py, m, vx=None, vy=None, bits=15):
        code = nbody_bh.morton_codes(px, py, jnp.min(px), jnp.max(px),
                                     jnp.min(py), jnp.max(py), bits)
        vals = [px, py, m] + ([vx, vy] if vx is not None else [])
        return list(jax.lax.sort((code, *vals), num_keys=1,
                                 is_stable=True)[1:])

    for name, fn in (("argsort_gather", argsort_gather), ("lax_sort", lax_sort),
                     ("lax_sort", lax_sort),
                     ("argsort_gather", argsort_gather)):
        nbody_bh.morton_sort = fn
        nbody_bh.step_bh.clear_cache()
        r = bm.bench_nbody(backend="bh", steps_per_dispatch=64, runs=3)
        emit(what="bh_sort", sort=name, steps_per_s=r["value"],
             spread_pct=r["spread_pct"])
    nbody_bh.morton_sort = argsort_gather


def main(argv):
    import jax

    from rustexp_tpu.core.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, got {dev}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    emit(what="card", nvidia_smi=smi, kind=dev.device_kind)
    for what in argv or ["raster", "tiles", "gol", "nbody", "bh"]:
        globals()[what]()


if __name__ == "__main__":
    main(sys.argv[1:])
