"""Routing/planning logic of the benchmark + the GoL kernel planner.

Pure-Python planner checks pin the tiling rules of the CUDA SWAR kernel
(they must never silently change), and tiny CPU runs lock the planner's
remainder launches and the bench routes."""

import jax.numpy as jnp
import numpy as np
import pytest

from rustexp_tpu.ops import gol_bits, gol_stencil


def _check_plan(plan, wn, cn, budget=gol_bits.SMEM_BYTES):
    assert wn % plan.bw == 0 and cn % plan.cw == 0
    th, tw = plan.bw + 2 * plan.hw, plan.cw + 2 * plan.hc
    assert gol_bits._tile_bytes(th, tw) <= budget
    # the halo covers kk generations in both axes, whole words in rows
    assert plan.hw * gol_bits.BITS >= plan.kk and plan.hc == plan.kk
    assert plan.cw % gol_bits.BITS == 0


def test_pick_plan_reproduces_measured_optima():
    """The bench shapes get valid plans: 2048^2 spreads over most SMs in
    one wave (one block cannot hold its 512 KB packed grid), and every
    plan fits the per-block shared-memory budget with its halos."""
    for n in (256, 2048, 4096, 8192):
        wn, cn = n // 32, n
        plan = gol_bits.pick_plan(wn, cn, 65536)
        _check_plan(plan, wn, cn)
    plan = gol_bits.pick_plan(64, 2048, 65536)
    blocks = (64 // plan.bw) * (2048 // plan.cw)
    assert gol_bits.NUM_SMS // 2 < blocks <= gol_bits.NUM_SMS


@pytest.mark.parametrize("budget", [4096, 16384, 96 * 1024])
def test_pick_plan_respects_smem_budget(budget):
    """Smaller shared-memory budgets shrink the tile, never overflow it,
    halos included."""
    plan = gol_bits.pick_plan(64, 2048, 1000, smem_bytes=budget)
    _check_plan(plan, 64, 2048, budget)


@pytest.mark.parametrize("k", [1, 7, 5000])
def test_pick_plan_small_grids_and_short_runs(k):
    """Grids down to one packed word row get a valid tiling, and a run
    shorter than the candidate generations per launch never launches
    more generations than asked (kk <= k)."""
    for n in (32, 64, 256, 512, 1024, 2048):
        plan = gol_bits.pick_plan(n // 32, n, k)
        _check_plan(plan, n // 32, n)
        assert plan.kk <= k


def test_chain_remainder_dispatch():
    """The tiled plan splits k = full*kk + rem into kk-generation launches
    plus one smaller remainder launch on the same tiles; the result must
    equal the roll oracle for k values that do not divide."""
    rng = np.random.default_rng(6)
    g = jnp.asarray(rng.integers(0, 2, (128, 256)).astype(np.int32))
    k = 75
    plan = gol_bits.Plan(1, 64, 16)
    assert k % plan.kk != 0  # the case under test
    assert gol_bits._launches(k, plan.kk) == [16, 16, 16, 16, 11]
    out = gol_bits.unpack_rows(gol_bits.multi_step_packed_tiled(
        gol_bits.pack_rows(g), k, plan))
    want = np.asarray(gol_stencil.multi_step(g, k, "roll"))
    np.testing.assert_array_equal(np.asarray(out), want)


@pytest.mark.parametrize("backend", ["bits", "bits_xla", "roll"])
def test_bench_gol_routes(backend):
    """bench_gol produces a well-formed metric on every route (tiny CPU
    run: the numbers themselves mean nothing here)."""
    from rustexp_tpu.app import benchmark

    out = benchmark.bench_gol(generations_per_dispatch=8, runs=1, n=64,
                              backend=backend)
    assert out["metric"] == "gol_cell_updates_per_s"
    assert out["value"] > 0 and out["gens_per_s"] > 0


def test_scene_backend_threshold():
    """Every mesh size takes the flat queue when the frame tiles (no
    triangle-count threshold: the queue beat the whole-frame oracle on
    the 12-triangle cube too); frames that do not tile take the oracle."""
    from rustexp_tpu.ops.raster_queue import TILE_H, TILE_W
    from rustexp_tpu.sims.rasterizer import _work_kind

    assert _work_kind(512, 512) == "queue"
    assert _work_kind(2 * TILE_W, TILE_H) == "queue"
    assert _work_kind(TILE_W + 8, TILE_H) == "xla"
    assert _work_kind(TILE_W, TILE_H + 1) == "xla"
