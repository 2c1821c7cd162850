"""Block-shortlist closest-hit intersector for large scenes (XLA-only).

The capability matched is the reference's BVH traversal
(``src/wgsl-util/intersection-logic.wgsl:1-215``); the mechanics are
redesigned as dense array work:

- triangles are selected per *block* of rays, not per ray, so the cost of
  a selection is amortized over the block;
- every round is branch-free over the full batch and the only scalar
  decision is the while_loop's global "anyone still improvable?".

Algorithm (exact — agrees with the brute sweep bit-for-bit on t):
  1. Triangles are packed in BVH-leaf order (models.pack), so consecutive
     CLUSTER-sized runs are spatially tight; cluster AABBs come from a
     per-cluster min/max reduction.
  2. Every ray slab-tests every cluster AABB once (vectorized tavianator
     test, cf. ray-bbox-intersection.wgsl:1-31); only the *block-min*
     entry distance [NB, C] is kept — the [B, C] matrix fuses into the
     reduction and never materializes.
  3. Rounds: each ray-block takes the K nearest unvisited clusters by
     static block-min entry order (front-to-back, like the reference's
     ordered traversal), sweeps their triangles (Möller–Trumbore, masked,
     repacked into 128-wide tiles), and updates per-ray best (t, id).
  4. The loop exits when every unvisited cluster's block-min entry exceeds
     the block-max best_t — conservative-exact (min_b enter >= max_b
     best_t implies enter[b] >= best_t[b] for every ray b), the same
     "node farther than closest hit" cull as the reference's traversal
     (intersection-logic.wgsl:178-181), amortized per block.

Coherent blocks (camera/shadow waves; pool lanes are spawned pixel-
contiguous) converge in 1-2 rounds; fully scrambled blocks fall back to
~T/(K·CLUSTER) rounds, i.e. never asymptotically worse than brute.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

EPS_TRI = 1e-8  # ray-triangle-intersection.wgsl:5
_INF = jnp.inf
_BIG_F = 3.0e38
_BIG_ID = 1.0e9  # > any triangle id; ids are exact in f32 (< 2^24)

# Defaults for 262k-ray camera/bounce waves over 2k-13k triangle meshes.
# Small clusters cull much tighter than large ones; the sweep repacks K
# gathered clusters into 128-wide tiles so each tile stays dense.
BLOCK = 256  # rays per shortlist decision
CLUSTER = 32  # triangles per cluster (gather/cull granularity)
K = 16  # clusters gathered per block per round (K*CLUSTER % 128 == 0)

# Component order in the packed cluster table.
_COMPS = 11  # v0.xyz e1.xyz e2.xyz id valid


def _cluster_table(scene, cluster: int):
    """(table [C, 11*cluster], lo [C,3], hi [C,3]) from the triangle SoA.

    Table column blocks are component-major so per-component slices are
    contiguous. Padding triangles carry valid=0 and contribute
    +/-inf-free bounds via masking; an all-padding cluster gets lo > hi,
    which the ranking masks out (its entry key stays +inf).
    """
    t = scene.tri_v0.shape[0]
    tp = -(-t // cluster) * cluster
    c = tp // cluster

    def pad(a):
        if tp == a.shape[0]:
            return a
        return jnp.concatenate(
            [a, jnp.zeros((tp - a.shape[0],) + a.shape[1:], a.dtype)], axis=0
        )

    v0, e1, e2 = pad(scene.tri_v0), pad(scene.tri_e1), pad(scene.tri_e2)
    valid = pad(scene.tri_valid)
    ids = jnp.arange(tp, dtype=jnp.float32)

    cols = [v0[:, 0], v0[:, 1], v0[:, 2],
            e1[:, 0], e1[:, 1], e1[:, 2],
            e2[:, 0], e2[:, 1], e2[:, 2],
            ids, valid.astype(jnp.float32)]
    table = jnp.concatenate(
        [col.reshape(c, cluster) for col in cols], axis=1
    )  # [C, 11*cluster]

    pts = jnp.stack([v0, v0 + e1, v0 + e2], axis=1)  # [tp, 3, 3]
    m = valid[:, None, None]
    lo = jnp.where(m, pts, _BIG_F).reshape(c, cluster * 3, 3).min(axis=1)
    hi = jnp.where(m, pts, -_BIG_F).reshape(c, cluster * 3, 3).max(axis=1)
    return table, lo, hi


def _enter_dists(o, d, lo, hi):
    """Slab entry distance of every ray to every cluster AABB -> [B, C].

    +inf on miss or degenerate (lo > hi) cluster. NaN-safe clamp of the
    direction reciprocal.
    """
    def inv(w):
        mag = jnp.maximum(jnp.abs(w), 1e-12)
        return jnp.where(w >= 0.0, 1.0, -1.0) / mag

    enter = None
    t_near = jnp.full((o.shape[0], lo.shape[0]), -_BIG_F)
    t_far = jnp.full((o.shape[0], lo.shape[0]), _BIG_F)
    for ax in range(3):
        i = inv(d[:, ax : ax + 1])  # [B, 1]
        t0 = (lo[None, :, ax] - o[:, ax : ax + 1]) * i
        t1 = (hi[None, :, ax] - o[:, ax : ax + 1]) * i
        t_near = jnp.maximum(t_near, jnp.minimum(t0, t1))
        t_far = jnp.minimum(t_far, jnp.maximum(t0, t1))
    ok = (t_far >= t_near) & (t_far > 0.0) & (lo[None, :, 0] <= hi[None, :, 0])
    return jnp.where(ok, jnp.maximum(t_near, 0.0), _INF)


def closest_tri_shortlist(
    scene,
    o,
    d,
    t_init=None,
    block: int = BLOCK,
    k: int = K,
    cluster: int = CLUSTER,
    max_rounds: int | None = None,
    any_hit: bool = False,
):
    """Closest triangle hit -> (t [B], tri_id [B]); see the impl docstring."""
    t, tid, _ = _closest_tri_shortlist_impl(
        scene, o, d, t_init=t_init, block=block, k=k, cluster=cluster,
        max_rounds=max_rounds, any_hit=any_hit,
    )
    return t, tid


@functools.partial(
    jax.jit, static_argnames=("block", "k", "cluster", "max_rounds", "any_hit")
)
def _closest_tri_shortlist_impl(
    scene,
    o,
    d,
    t_init=None,
    block: int = BLOCK,
    k: int = K,
    cluster: int = CLUSTER,
    max_rounds: int | None = None,
    any_hit: bool = False,
):
    """Closest triangle hit -> (t [B] f32 — inf on miss, tri_id [B] i32 —
    -1 on miss). Exact match with ``intersect.closest_tri_brute``.

    ``t_init`` (optional [B] f32) caps the search: only hits strictly before
    it are found (lanes with no such hit return ``t_init`` unchanged and id
    -1-or-stale). The occlusion variant ``occluded_tri_shortlist`` uses this
    — starting ``best_t`` at the shadow-ray cutoff makes the improvable cull
    far stronger (a cluster whose entry distance exceeds the cutoff is never
    swept), the same distance cull as the reference traversal
    (intersection-logic.wgsl:178-181) but against t_max instead of +inf.
    """
    b = o.shape[0]
    bp = -(-b // block) * block
    if bp != b:
        pad = bp - b
        o = jnp.concatenate([o, jnp.full((pad, 3), 1e30, o.dtype)], axis=0)
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], d.dtype), (pad, 1))],
            axis=0,
        )
        if t_init is not None:
            t_init = jnp.concatenate(
                [t_init, jnp.zeros((pad,), t_init.dtype)], axis=0
            )
    nb = bp // block

    table, lo, hi = _cluster_table(scene, cluster)
    c = lo.shape[0]
    kc = min(k, c)
    if max_rounds is None:
        max_rounds = -(-c // kc)  # exactness backstop: can visit every cluster

    # Only the block-min entry distance is kept ([NB, C]); the full [B, C]
    # matrix fuses into this reduction and never materializes. Ranking on
    # the static block-min (nearest-first, like a front-to-back BVH walk)
    # with a max-over-block best_t cull is conservative-exact: a cluster is
    # skipped only when min_b enter[b,c] >= max_b best_t[b], which implies
    # enter[b,c] >= best_t[b] for every ray b in the block. This replaces
    # the earlier per-round exact key (a [NB, block, C] reduction that
    # dominated the round cost ~2:1 over the actual triangle sweep).
    min_enter = jnp.min(
        _enter_dists(o, d, lo, hi).reshape(nb, block, c), axis=1
    )  # [NB, C]

    # Ray components per block (data-dependent zero keeps shard_map axes).
    zero = (o[:, 0] + d[:, 0]) * 0.0
    rx = (o[:, 0] + zero).reshape(nb, block, 1)
    ry = (o[:, 1] + zero).reshape(nb, block, 1)
    rz = (o[:, 2] + zero).reshape(nb, block, 1)
    wx = (d[:, 0] + zero).reshape(nb, block, 1)
    wy = (d[:, 1] + zero).reshape(nb, block, 1)
    wz = (d[:, 2] + zero).reshape(nb, block, 1)

    iota_c = jnp.arange(c, dtype=jnp.int32)

    best_t0 = zero + _INF if t_init is None else zero + t_init
    def improvable_key(best_t_max, visited):
        """Ranking key per still-useful cluster -> [NB, C] (cheap: O(NB*C))."""
        return jnp.where(
            visited | (min_enter >= best_t_max[:, None]), _INF, min_enter
        )

    best_t0 = best_t0.reshape(nb, block)
    visited0 = (zero[:nb, None] != 0.0) | jnp.zeros((nb, c), bool)
    key0 = improvable_key(jnp.max(best_t0, axis=1), visited0)
    state = dict(
        best_t=best_t0,
        best_id=(zero.astype(jnp.int32) - 1).reshape(nb, block),
        visited=visited0,
        go=jnp.any(jnp.isfinite(key0)),
        rounds=jnp.int32(0),
    )

    # A zero row (valid = 0) at index C backs the unselected top-k slots:
    # blocks with fewer than K improvable clusters gather it and the sweep
    # mask drops its triangles.
    table_pad = jnp.concatenate([table, jnp.zeros((1, table.shape[1]))], axis=0)

    # Gathered cluster tiles are repacked to 128-wide sweep rows so small
    # CLUSTER values (tighter culling) keep every sweep tile dense.
    sweep_w = 128 if (kc * cluster) % 128 == 0 else cluster
    n_sweep = kc * cluster // sweep_w

    def cond(st):
        return st["go"] & (st["rounds"] < max_rounds)

    def body(st):
        best_t, best_id, visited = st["best_t"], st["best_id"], st["visited"]
        key = improvable_key(jnp.max(best_t, axis=1), visited)

        # K-nearest clusters per block in one fused top-k (an iterative
        # min extraction would be K dependent [NB, C] passes).
        neg, idx = jax.lax.top_k(-key, kc)  # [NB, K]
        picked = jnp.isfinite(neg)
        idx = jnp.where(picked, idx, c)  # -> zero pad row
        visited = visited | jnp.any(
            idx[:, :, None] == iota_c[None, None, :], axis=1
        )

        # Gather the shortlisted clusters' triangle rows: per-*block* row
        # gathers, K/block-th of what per-ray gathers would move.
        g = jnp.take(table_pad, idx.reshape(nb * kc), axis=0)
        # Repack component-major: [NB, comps, K*cluster] (cheap — g is a
        # few MB), then sweep dense 128-wide slices.
        g = (
            g.reshape(nb, kc, _COMPS, cluster)
            .transpose(0, 2, 1, 3)
            .reshape(nb, _COMPS, kc * cluster)
        )

        def comp(j, s):
            return g[:, j, s * sweep_w : (s + 1) * sweep_w][:, None, :]

        # Sweep the repacked tiles with a running (t, id) minimum — the
        # same fused elementwise+reduce shape as the brute sweep's tiles.
        for s in range(n_sweep):
            ax, ay, az = comp(0, s), comp(1, s), comp(2, s)
            bx, by, bz = comp(3, s), comp(4, s), comp(5, s)
            cx, cy, cz = comp(6, s), comp(7, s), comp(8, s)
            tid, tval = comp(9, s), comp(10, s)

            px = wy * cz - wz * cy
            py = wz * cx - wx * cz
            pz = wx * cy - wy * cx
            det = bx * px + by * py + bz * pz
            inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS_TRI, det, 1.0)
            sx, sy, sz = rx - ax, ry - ay, rz - az
            u = (sx * px + sy * py + sz * pz) * inv_det
            qx = sy * bz - sz * by
            qy = sz * bx - sx * bz
            qz = sx * by - sy * bx
            v = (wx * qx + wy * qy + wz * qz) * inv_det
            t = (cx * qx + cy * qy + cz * qz) * inv_det
            ok = (
                (jnp.abs(det) > EPS_TRI)
                & (u >= 0.0)
                & (u <= 1.0)
                & (v >= 0.0)
                & (u + v <= 1.0)
                & (t > EPS_TRI)
                & (tval > 0.5)
            )
            t = jnp.where(ok, t, _INF)
            tile_t = jnp.min(t, axis=2)  # [NB, block]
            tile_id = jnp.min(
                jnp.where(t == tile_t[:, :, None], tid, _BIG_ID), axis=2
            )
            better = tile_t < best_t
            best_t = jnp.where(better, tile_t, best_t)
            best_id = jnp.where(better, tile_id.astype(jnp.int32), best_id)

        if any_hit:
            # Occlusion mode: any hit before the cutoff (best_t improved,
            # since it started AT the cutoff) retires the ray — forcing
            # best_t to 0 both keeps t < t_cut true for the caller and
            # shrinks the block-max cull so whole blocks exit sooner. Only
            # the occluded_* wrapper sets this (closest-hit contract given
            # up). Cf. the reference shadow query's first-hit early-out.
            best_t = jnp.where(best_t < best_t0, 0.0, best_t)
        key = improvable_key(jnp.max(best_t, axis=1), visited)
        return dict(
            best_t=best_t,
            best_id=best_id,
            visited=visited,
            go=jnp.any(jnp.isfinite(key)),
            rounds=st["rounds"] + 1,
        )

    st = jax.lax.while_loop(cond, body, state)
    t_out = st["best_t"].reshape(bp)[:b]
    id_out = st["best_id"].reshape(bp)[:b]
    return t_out, jnp.where(jnp.isfinite(t_out), id_out, -1), st["rounds"]


def closest_tri_shortlist_stats(scene, o, d, **kw):
    """Diagnostic variant -> (t, tri_id, rounds executed)."""
    return _closest_tri_shortlist_impl(scene, o, d, **kw)


def occluded_tri_shortlist(
    scene,
    o,
    d,
    t_cut,
    block: int = BLOCK,
    k: int = K,
    cluster: int = CLUSTER,
):
    """Shadow occlusion -> occluded [B] bool (some triangle strictly before
    ``t_cut``). Exact match with the brute occlusion sweep's ``occ`` output.

    Same loop as the closest-hit shortlist, but ``best_t`` starts at the
    cutoff, so clusters entirely beyond the light sample are never swept and
    the loop exits as soon as no unvisited cluster reaches in front of it.
    Runs in any-hit mode: the first hit before the cutoff retires the ray.
    """
    t, _ = closest_tri_shortlist(
        scene, o, d, t_init=t_cut, block=block, k=k, cluster=cluster,
        any_hit=True,
    )
    return t < t_cut
