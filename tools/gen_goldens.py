#!/usr/bin/env python
"""Generate the reference-scene goldens (CPU; run from repo root).

Writes tests/goldens/ref_<scene>.npz — the full 512^2 frame of every one
of the 12 bench scenes (rasterizer.rs:1791-1812 configs: Fill, CMRefl,
Grace, tick 0). Renders use the XLA oracle backend — the backends are
proven pairwise bit-equal by tests/test_raster.py, so one anchor serves
all. Comparison in tests allows a <=0.3% pixel-diff sprinkle: XLA:CPU
codegen varies fma fusion across host CPU generations, which flips the
depth winner on shared-edge pixels where two triangles tie within an ulp
(observed when the terminal was re-provisioned onto a different host).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, ".")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

# Goldens are the CPU chain's frames: pin the platform and verify.
jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()

import jax.numpy as jnp

from rustexp_tpu.app.benchmark import SCENES, W, H, SHADER, TICK
from rustexp_tpu.assets import cubemap, mesh
from rustexp_tpu.raster import camera, pipeline as pp

GOLDEN_DIR = os.path.join("tests", "goldens")


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for label, mesh_idx, per_pixel, _ref in SCENES:
        m = mesh.get_mesh(mesh_idx)
        scene = pp.make_scene(m, cubemap.get_cm_set(0))
        eye = jnp.asarray(camera.camera_eye(mesh.mesh_camera(mesh_idx), TICK))
        fb = np.asarray(pp.render_frame(
            scene, eye, TICK, w=W, h=H, per_pixel=per_pixel,
            shader_idx=SHADER, show_cm=False, backend="xla"))
        np.savez_compressed(
            os.path.join(GOLDEN_DIR, f"ref_{label}.npz"), fb=fb)
        print(f"{label:<12} checksum {int(fb.astype(np.uint64).sum()):#x}",
              flush=True)
    print("wrote", GOLDEN_DIR)


if __name__ == "__main__":
    main()
