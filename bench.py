#!/usr/bin/env python
"""Benchmark entry point — prints ONE JSON line with the headline metric.

Headline: shaded-rasterization throughput in Mpix/s over the reference's
12-scene benchmark suite (rasterizer.rs:1781-1884: 512x512, Fill, shader 5
CMRefl, envmap Grace, tick 0; best-of-N timing). `vs_baseline` is the speedup
of the suite total vs the reference CPU's stored 27,286 us total
(BASELINE.md). Secondary fields: GoL cell updates/s at 256^2 and 2048^2,
block-BH and brute-force N-body steps/s at N=131,072, and the per-frame
in-graph-rebuild moving-camera suite.

Runs on a GPU only: a measurement that finds no GPU fails instead of timing
the CPU. Any failed step fails the run (non-zero exit, no JSON line).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _git_sha() -> str:
    try:
        out = subprocess.run(["git", "-C", str(ROOT), "rev-parse",
                              "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def _engine_hash() -> str:
    """Content hash of the engine package + this harness."""
    h = hashlib.sha256()
    files = sorted((ROOT / "rustexp_tpu").rglob("*"))
    for p in files + [ROOT / "bench.py"]:
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(ROOT)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def compose_summary(r: dict) -> dict:
    """One JSON line from the completed metrics."""
    from rustexp_tpu.app.benchmark import SCENES, W, H

    scenes = {name: r[f"scene:{name}"] for name, *_ in SCENES}
    total_us = sum(v["us"] for v in scenes.values())
    ref_total = sum(v["ref_us"] for v in scenes.values())
    out = {
        "metric": "raster_suite_Mpix_per_s",
        "value": round(len(scenes) * W * H / total_us, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(ref_total / total_us, 3),
        "suite_total_us": round(total_us),
        "scenes_done": len(scenes),
        "scene_us": {k: round(v["us"], 1) for k, v in scenes.items()},
        # In-session best-to-worst spread per scene: the noise floor
        # travels with the numbers.
        "scene_spread_pct": {k: v["spread_pct"] for k, v in scenes.items()},
        "gol_cell_updates_per_s": r["gol_256"]["value"],
        "gol_gens_per_s": r["gol_256"]["gens_per_s"],
        "gol_spread_pct": r["gol_256"]["spread_pct"],
        "gol_2048_cell_updates_per_s": r["gol_2048"]["value"],
        "gol_2048_spread_pct": r["gol_2048"]["spread_pct"],
        "nbody_bh_steps_per_s_131k": r["nbody_bh"]["value"],
        "nbody_bh_spread_pct": r["nbody_bh"]["spread_pct"],
        "nbody_brute_steps_per_s_131k": r["nbody_brute"]["value"],
    }
    moving = {name: r[f"moving:{name}"] for name, *_ in SCENES}
    mv_total = sum(v["value"] for v in moving.values())
    out["moving_suite_total_us"] = round(mv_total)
    out["moving_scenes_done"] = len(moving)
    out["moving_vs_baseline"] = round(ref_total / mv_total, 3)
    out["moving_scene_us"] = {k: round(v["value"], 1)
                              for k, v in moving.items()}
    out["moving_scene_spread_pct"] = {k: v["spread_pct"]
                                      for k, v in moving.items()}
    out["raster_moving_camera_us_KillerooP"] = moving["KillerooP"]["value"]
    out["sha"] = _git_sha()
    out["engine_hash"] = _engine_hash()
    return out


def main():
    from rustexp_tpu.core.platform import enable_compile_cache, kernel_mode

    enable_compile_cache()
    import jax

    if kernel_mode() != "compiled":
        raise SystemExit(f"bench.py measures the GPU; the default backend "
                         f"is {jax.default_backend()!r}")
    from rustexp_tpu.app import benchmark as bm

    def scene_step(mesh_idx, per_pixel, ref_us):
        def run():
            st = bm.bench_scene(mesh_idx, per_pixel, runs=20,
                                return_stats=True)
            return {"us": st["best"] * 1e6, "ref_us": ref_us,
                    "speedup": round(ref_us / (st["best"] * 1e6), 3),
                    "us_median": round(st["median"] * 1e6, 1),
                    "spread_pct": st["spread_pct"],
                    "n_runs": st["n_runs"]}
        return run

    steps = [
        ("gol_256", lambda: bm.bench_gol()),
        ("gol_2048", lambda: bm.bench_gol(n=2048,
                                          generations_per_dispatch=65536)),
        ("nbody_bh", lambda: bm.bench_nbody(backend="bh")),
        ("nbody_brute", lambda: bm.bench_nbody(backend="pallas",
                                               steps_per_dispatch=32)),
    ]
    for name, mesh_idx, per_pixel, ref_us in bm.SCENES:
        steps.append((f"scene:{name}", scene_step(mesh_idx, per_pixel,
                                                  ref_us)))
    # Moving-camera suite: per-frame in-graph queue rebuild for every scene.
    for name, mesh_idx, per_pixel, _ in bm.SCENES:
        steps.append((f"moving:{name}",
                      lambda m=mesh_idx, p=per_pixel: bm.bench_scene_moving(
                          m, p, runs=4, k=128)))

    results = {}
    for name, fn in steps:
        results[name] = fn()
        print(f"# {name}: {results[name]}", file=sys.stderr, flush=True)
    out = compose_summary(results)
    dev = jax.devices()[0]
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
