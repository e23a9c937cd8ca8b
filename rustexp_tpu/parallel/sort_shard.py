"""Distributed stable sort over the device mesh (hypercube bitonic).

A replicated Morton sort makes every device gather all N particles and
sort all N keys, so the sort never shrinks with the device count D and
caps the sharded Barnes-Hut step's scaling. This module shards the sort
itself.

Algorithm (classic hypercube bitonic sort with compare-split, the
distributed-memory form of Batcher's network): each device holds one
contiguous chunk of n_loc = N / D elements,

  1. locally sorted once (`lax.sort` with the payloads as operands), then
  2. log D * (log D + 1) / 2 cross-device stages. A stage exchanges the
     FULL chunk with the XOR-partner device (`lax.ppermute`), keeps the
     elementwise min (or max) against the index-REVERSED partner chunk —
     Batcher's bitonic split: for ascending length-n arrays A and B,
     {min(A_i, B_{n-1-i})} is exactly the multiset of the n smallest of
     A ∪ B — and restores local order with one local sort.

After the last stage device d holds the d-th chunk of the global sorted
order. All comparisons are on the lexicographic (key, global position)
pair, so ties resolve exactly as a replicated stable sort of the
gathered input would — the concatenated result is BIT-IDENTICAL to
`jnp.argsort(key, stable=True)` applied to every array, which is the
property the sharded BH step's single-device-parity contract needs.

Cost model (per device, vs the replicated sort of all N):
one local sort of n_loc plus log D (log D + 1)/2 stages of (full-chunk
exchange + local re-sort of n_loc), the exchanges riding the same links
as the source all-gather.

Reference analog: the reference rebuilds its quadtree serially every
step on one thread (nbody.rs:410-417); here every chip pays 1/D-th of
the spatial-structure cost.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _substage_table(n: int) -> tuple[list[int], list[int]]:
    """(j, k) per compare-exchange substage of the n-element bitonic
    network — here n is the device count, one substage per exchange."""
    js, ks = [], []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            js.append(j)
            ks.append(k)
            j //= 2
        k *= 2
    return js, ks


def _local_sort(key, gidx, values):
    """Sort by the lexicographic (key, global position) pair, payloads
    carried as extra sort operands (no permutation gathers)."""
    out = lax.sort((key, gidx, *values), num_keys=2)
    return out[0], out[1], list(out[2:])


def dist_sort_stable(key, values, axis, n_dev: int):
    """[call INSIDE shard_map] Distributed stable sort by i32 `key`.

    `key` and each of `values` are the device's local [n_loc] chunk of
    logically-concatenated global arrays sharded on `axis` (one mesh
    axis name or a tuple — collectives linearize the product, same as
    gol_shard). Returns (key, gidx, values) where device d holds the
    d-th contiguous chunk of the global stable-sort order and `gidx` is
    each element's position in the ORIGINAL global concatenation.

    Power-of-two D runs the hypercube bitonic schedule
    (log D (log D + 1)/2 exchange stages); any other D runs block
    odd-even transposition (D stages of neighbor compare-splits — the
    classic any-D distributed sort; round-5 VERDICT #4c replaced the
    silent replicated-sort fallback that made D = 6/12 pods pay full-N
    sort work per device). D == 1 degenerates to the local sort.
    """
    n_loc = key.shape[0]
    dev = lax.axis_index(axis).astype(jnp.int32)
    gidx = dev * n_loc + jnp.arange(n_loc, dtype=jnp.int32)
    key, gidx, values = _local_sort(key, gidx, values)
    if n_dev == 1:
        return key, gidx, values

    def split_stage(perm, keep_min, active, key, gidx, values):
        # index-reversed partner chunk: compare element i against the
        # partner's element n_loc-1-i. Both chunks are ascending, so
        # own ++ reversed(partner) is bitonic and Batcher's split holds:
        # {min(A_i, B_{n-1-i})} is exactly the n smallest of A ∪ B.
        pk = lax.ppermute(key, axis, perm)[::-1]
        pg = lax.ppermute(gidx, axis, perm)[::-1]
        pv = [lax.ppermute(v, axis, perm)[::-1] for v in values]
        mine_first = (key < pk) | ((key == pk) & (gidx < pg))
        keep_own = jnp.where(active,
                             jnp.where(keep_min, mine_first, ~mine_first),
                             True)
        key = jnp.where(keep_own, key, pk)
        gidx = jnp.where(keep_own, gidx, pg)
        values = [jnp.where(keep_own, v, p) for v, p in zip(values, pv)]
        return _local_sort(key, gidx, values)

    if n_dev & (n_dev - 1) == 0:
        for j, k in zip(*_substage_table(n_dev)):
            perm = [(d, d ^ j) for d in range(n_dev)]
            # block-level bitonic direction: the low side (bit j clear)
            # of an ascending run (bit k clear) keeps the min-half
            keep_min = ((dev & j) == 0) == ((dev & k) == 0)
            key, gidx, values = split_stage(perm, keep_min, True,
                                            key, gidx, values)
    else:
        for p in range(n_dev):
            # phase p pairs devices (2i + p%2, 2i + p%2 + 1); edge
            # devices without a partner self-map and keep their chunk
            def pair_of(d):
                q = d + 1 if (d - p) % 2 == 0 else d - 1
                return q if 0 <= q < n_dev else d
            perm = [(d, pair_of(d)) for d in range(n_dev)]
            q = jnp.where((dev - p) % 2 == 0, dev + 1, dev - 1)
            active = (q >= 0) & (q < n_dev)
            keep_min = dev < q     # lower device of the pair keeps mins
            key, gidx, values = split_stage(perm, keep_min, active,
                                            key, gidx, values)
    return key, gidx, values
