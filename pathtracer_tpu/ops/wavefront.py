"""Regenerative wavefront renderer.

The fixed-depth scan integrator (ops.integrator) pays ``max_depth`` bounces
for every path even though the average CornellBox path dies after ~3.5
(emissive hit, escape, or Russian roulette) — most lanes are masked-dead
most of the time. This renderer keeps a pool of B lanes *always busy*:
whenever a lane's path terminates, the lane immediately flushes its
accumulated radiance into the image (scatter-add by pixel id) and loads the
next (pixel, sample) ray from a global counter. Utilization stays near 100%
and wall-clock drops by roughly the ratio of max_depth to mean path length
(~4x on the headline workload).

This is the classic GPU "path regeneration" wavefront in array form: the
pool is a flat SoA batch, regeneration is a masked prefix-sum id
assignment (no compaction), and the loop is a ``lax.while_loop``
that exits when the ray counter is exhausted and every lane is idle.
Because all randomness is counter-based on (pixel, sample) (ops.rng), the
result is identical in distribution — and per-ray identical — to the scan
integrator; only float accumulation order differs.

Gradients: use the scan integrator (this loop is inference-only; while_loop
is not reverse-differentiable).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.camera_rays import generate_rays
from pathtracer_tpu.ops.integrator import bounce_core

# Flush-group width: each group of W lanes (strided B/W apart) flushes at
# most one finished path per iteration, shrinking the image scatter to
# [B/W] rows. Lanes finish at ~0.2/iter on the headline workload, so W=4
# (capacity 0.25 paths/lane/iter) still drains the hold queue; W=8 would
# throttle completions and inflate the iteration count instead.
_FLUSH_WAYS = 4

# Ray-sort spatial grid resolution per axis (16 -> 12-bit Morton cell).
_SORT_GRID = 16.0


def _spread3(x, bits: int = 3):
    """Spread the low ``bits`` bits of a u32 with 2-bit gaps (3D Morton)."""
    r = x & jnp.uint32(1)
    for i in range(1, bits):
        r = r | (((x >> i) & jnp.uint32(1)) << (3 * i))
    return r


def _sort_key(o, d, alive, lo, inv_extent):
    """[B] u32 coherence key: dead-grouping bit | Morton cell of the ray
    origin (scene-AABB-normalized _SORT_GRID^3 grid; 16^3 default -> 12
    bits) | 3-bit direction octant.

    Lanes sorted by this key land in 256-ray blocks whose rays share both
    a spatial cell and a direction octant — exactly the coherence the
    block-granular shortlist intersectors convert into skipped cluster
    sweeps (a block's cluster union approaches its per-ray shortlists).
    Dead/holding lanes group at the end (their stale rays are parked by
    the integrator; grouping makes those blocks root-test out in one step).
    """
    g = _SORT_GRID
    bits = max(1, int(g - 1).bit_length())
    cell = jnp.clip((o - lo) * inv_extent * g, 0.0, g - 1.0).astype(jnp.uint32)
    morton = (
        (_spread3(cell[:, 0], bits) << 2)
        | (_spread3(cell[:, 1], bits) << 1)
        | _spread3(cell[:, 2], bits)
    )
    octant = (
        (d[:, 0] < 0.0).astype(jnp.uint32) * 4
        + (d[:, 1] < 0.0).astype(jnp.uint32) * 2
        + (d[:, 2] < 0.0).astype(jnp.uint32)
    )
    dead = (~alive).astype(jnp.uint32)
    return (dead << (3 * bits + 3)) | (morton << 3) | octant


def _sort_pool_state(st, lo, inv_extent):
    """Reorder the lane axis of the pool state by the coherence key.

    The pool is lane-anonymous (all randomness is counter-based on the
    global (pixel, sample) carried *with* each lane, the spawn counter is
    global, and the flush scatter goes by pixel id), so any permutation of
    the lane axis yields the same per-path radiance bit-for-bit; only the
    image's fp accumulation order changes. What the sort costs against
    what it saves the block-shortlist on incoherent bounce waves is
    ROADMAP S5.
    """
    key = _sort_key(st["o"], st["d"], st["alive"], lo, inv_extent)
    flags = (
        st["depth"].astype(jnp.uint32)
        | (st["alive"].astype(jnp.uint32) << 8)
        | (st["holding"].astype(jnp.uint32) << 9)
        | (st["spec"].astype(jnp.uint32) << 10)
        | (st["chunk_left"] << 11)
    )
    ops = jax.lax.sort(
        (
            key,
            st["o"][:, 0], st["o"][:, 1], st["o"][:, 2],
            st["d"][:, 0], st["d"][:, 1], st["d"][:, 2],
            st["beta"][:, 0], st["beta"][:, 1], st["beta"][:, 2],
            st["radiance"][:, 0], st["radiance"][:, 1], st["radiance"][:, 2],
            st["acc"][:, 0], st["acc"][:, 1], st["acc"][:, 2],
            st["pixel"], st["sample"], flags,
        ),
        num_keys=1,
    )
    (_, ox, oy, oz, dx, dy, dz, bx, by, bz, rx, ry, rz, ax, ay, az,
     pixel, sample, flags) = ops
    return dict(
        st,
        o=jnp.stack([ox, oy, oz], axis=-1),
        d=jnp.stack([dx, dy, dz], axis=-1),
        beta=jnp.stack([bx, by, bz], axis=-1),
        radiance=jnp.stack([rx, ry, rz], axis=-1),
        acc=jnp.stack([ax, ay, az], axis=-1),
        pixel=pixel,
        sample=sample,
        depth=(flags & jnp.uint32(0xFF)).astype(jnp.int32),
        alive=(flags >> 8) & 1 == 1,
        holding=(flags >> 9) & 1 == 1,
        spec=(flags >> 10) & 1 == 1,
        chunk_left=flags >> 11,
    )


def _compact_bits(x):
    """Drop the odd bits of a u32 (inverse of 2D Morton interleave)."""
    x = x & jnp.uint32(0x55555555)
    x = (x | (x >> 1)) & jnp.uint32(0x33333333)
    x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
    return x


def _morton_pixel(p, width: int):
    """Morton (Z-order) pixel for linear spawn index ``p`` (square 2^k dims).

    Consecutive spawn ids then cover 2^j x 2^j pixel *tiles* instead of
    scanline strips, so the block-granular intersectors
    (ops.intersect_shortlist*) see spatially tight camera waves — a
    256-lane block is a 16x16 tile whose rays share a handful of BVH-leaf
    clusters, vs a half-scanline crossing the whole frustum. Pure bit
    permutation of the pixel id space: same (pixel, sample) pairs overall,
    same per-path radiance (counter RNG), only flush order changes.
    """
    x = _compact_bits(p)
    y = _compact_bits(p >> jnp.uint32(1))
    return y * jnp.uint32(width) + x


def resolve_spawn_chunk(settings, n_pixels: int, rays_per_pixel: int) -> int:
    """Concrete samples-per-spawn K for this workload (resolving auto = 0).

    Chunked spawning trades flush-scatter rows (divided by K) for
    work-stealing slack (the global counter balances chunks, not paths):
    with few chunks per lane, the static-assignment tail of K-path chunks
    costs more than the flush saves. Auto draws the line at >= 16
    chunks/lane of slack. Whether these thresholds hold on the GPU, where
    the scatter is atomics, is ROADMAP S3.

    Short-path regimes (directLightingOnly, or rr continuation <= 0.5 so
    the mean path dies in < 2 bounces) chunk UNCONDITIONALLY: every lane
    finishes ~every iteration, so the B/4-row flush throttles the whole
    pool — and near-zero path-length variance removes the
    static-assignment-tail risk that gates chunking elsewhere.
    """
    if settings.spawn_chunk != 0:
        return max(1, settings.spawn_chunk)
    total = n_pixels * rays_per_pixel
    batch = min(settings.batch_size, total)
    short_paths = settings.direct_lighting_only or settings.rr_prob <= 0.5
    if short_paths or total >= 16 * 4 * batch:
        return 4
    # Middle band: K=2 keeps >= 16 chunks/lane of slack and still halves
    # the flush (cornell spp50 takes K=2; spp16 stays K=1).
    if total >= 16 * 2 * batch:
        return 2
    return 1


def pool_ids_total(settings, n_pixels: int, rays_per_pixel: int) -> int:
    """Size of the pool's padded pixel-major global ray-id space.

    Sharding/denominator callers must slice THIS space (in K-aligned
    slices, K = resolve_spawn_chunk(...)) — slicing the raw path count
    n_pixels * rays_per_pixel under- or mis-covers when K > 1.
    """
    k = resolve_spawn_chunk(settings, n_pixels, rays_per_pixel)
    return n_pixels * (-(-rays_per_pixel // k) * k)


def _spawn_order_morton(settings, n_pixels: int) -> bool:
    return (
        settings.width == settings.height
        and settings.width & (settings.width - 1) == 0
        and settings.width > 1
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "settings", "n_pixels", "batch", "rays_per_pixel", "sample_offset",
        "n_ids",
    ),
)
def render_pool(
    scene,
    frame,
    settings,
    n_pixels: int,
    batch: int,
    rays_per_pixel: int,
    sample_offset: int = 0,
    id_offset=None,
    id_limit=None,
    n_ids: int | None = None,
):
    """Trace ``n_pixels * rays_per_pixel`` paths -> (image [P, 3] radiance sum,
    rays_traced, iterations).

    Ray-id space (round 5): **pixel-major, chunk-padded**. With K =
    ``settings.spawn_chunk`` and spp_pad = ceil(rays_per_pixel / K) * K,
    id = pixel * spp_pad + sample_local; ids with sample_local >=
    rays_per_pixel are padding holes (never traced). A lane spawn claims a
    whole K-id chunk (one pixel, K consecutive samples), re-aims itself
    in place as each path finishes, and flushes ONE accumulated image row
    per chunk — chunking divides the flush scatter's rows by ~K.
    ``sample_offset`` shifts the sample
    indices so chunked/resumed renders reproduce the straight-through
    result.

    Sharding hooks (parallel.render.render_pool_sharded): the pool can own
    a slice of the global (padded) id space. ``n_ids`` (static) is the
    slice length, ``id_offset`` (traced u32) shifts local ids to global
    ones and MUST be a multiple of K (use ``pool_ids_total`` /
    K-aligned per-device slices), and ``id_limit`` (traced u32) caps the
    padded-id count for a ragged final slice. All randomness is
    counter-based on the *global* (pixel, sample), so per-path radiance is
    bit-identical however the id space is sliced or chunked.
    """
    k_chunk = resolve_spawn_chunk(settings, n_pixels, rays_per_pixel)
    spp_pad = -(-rays_per_pixel // k_chunk) * k_chunk
    total = n_ids if n_ids is not None else n_pixels * spp_pad
    limit = jnp.uint32(total if id_limit is None else id_limit)
    offset = jnp.uint32(0 if id_offset is None else id_offset)
    num_chunks = -(-total // k_chunk)
    b = min(batch, num_chunks)
    b += (-b) % _FLUSH_WAYS  # W-way flush groups; extra lanes stay idle

    morton = _spawn_order_morton(settings, n_pixels)

    def chunk_info(start_ids):
        """(pixel, first sample, valid path count) for [B] chunk-start ids
        (local, multiples of K)."""
        gids = start_ids + offset
        pixel = (gids // jnp.uint32(spp_pad)).astype(jnp.uint32)
        s_local = (gids % jnp.uint32(spp_pad)).astype(jnp.uint32)
        if morton:
            pixel = _morton_pixel(pixel, settings.width)
        sample = s_local + jnp.uint32(sample_offset)
        # Valid samples in this chunk: within the pixel's real spp and
        # within the LOCAL slice limit (``limit`` caps local ids, matching
        # the spawn counter; i32 math — u32 would underflow on beyond-limit
        # lanes; id spaces stay far below 2^31).
        count = jnp.clip(
            jnp.minimum(
                jnp.int32(rays_per_pixel) - s_local.astype(jnp.int32),
                limit.astype(jnp.int32) - start_ids.astype(jnp.int32),
            ),
            0,
            k_chunk,
        ).astype(jnp.uint32)
        return pixel, sample, count

    def cam(pixel, sample):
        jitter = rng.pixel_jitter(settings, pixel, sample)
        return generate_rays(
            frame, settings.width, settings.height, pixel, jitter
        )

    # Initial fill: lanes take chunks 0..b-1.
    ids0 = jnp.arange(b, dtype=jnp.uint32) * jnp.uint32(k_chunk)
    pixel, sample, count0 = chunk_info(ids0)
    o, d = cam(pixel, sample)

    # Inits must be *data-dependent* on the (possibly shard_map-varying)
    # ray state so the while_loop carry in/out types match — constant
    # zeros/ones fold to replicated types and lose the varying axis.
    zero3 = (o + d) * 0.0
    zero = zero3[:, 0]
    vary_u32 = offset * jnp.uint32(0)

    state = dict(
        o=o,
        d=d,
        beta=zero3 + 1.0,
        radiance=zero3,
        acc=zero3,
        alive=count0 > 0,
        holding=zero != 0.0,
        spec=zero != 0.0,
        pixel=pixel,
        sample=sample,
        depth=zero.astype(jnp.int32),
        chunk_left=count0,
        image=jnp.zeros((n_pixels, 3), jnp.float32) + zero3[0] * 0.0,
        next_id=jnp.uint32(b * k_chunk) + vary_u32,
        n_rays=jnp.sum(zero),
        iters=jnp.int32(0) + vary_u32.astype(jnp.int32),
    )

    # Ray sorting: reorder the lane axis by (spatial cell, direction octant)
    # each iteration so the block-granular shortlist sees coherent 256-ray
    # blocks even on bounce-scrambled waves, which cuts the clusters each
    # block's union must sweep. Off for the brute sweep, whose cost is
    # lane-order independent.
    from pathtracer_tpu.ops.intersect import resolve_intersector

    sort_rays = settings.ray_sort == "on" or (
        settings.ray_sort == "auto"
        and resolve_intersector(settings, scene) == "shortlist"
    )
    if sort_rays:
        pts = jnp.concatenate(
            [
                scene.tri_v0,
                scene.tri_v0 + scene.tri_e1,
                scene.tri_v0 + scene.tri_e2,
            ],
            axis=0,
        )
        valid3 = jnp.tile(scene.tri_valid, 3)[:, None]
        sort_lo = jnp.min(jnp.where(valid3, pts, jnp.inf), axis=0)
        sort_hi = jnp.max(jnp.where(valid3, pts, -jnp.inf), axis=0)
        sort_inv = 1.0 / jnp.maximum(sort_hi - sort_lo, 1e-12)

    def cond(st):
        return jnp.any(st["alive"] | st["holding"])

    def body(st):
        if sort_rays:
            st = _sort_pool_state(st, sort_lo, sort_inv)
        o, d, beta, radiance, alive, spec, n = bounce_core(
            scene,
            settings,
            st["o"],
            st["d"],
            st["beta"],
            st["radiance"],
            st["alive"],
            st["spec"],
            st["pixel"],
            st["sample"],
            st["depth"],
        )
        depth = st["depth"] + 1
        # Depth cap (reference: while depth <= 16 -> max_depth bounces).
        alive = alive & (depth < settings.max_depth)

        # A lane whose path ended but whose chunk has samples left re-aims
        # itself in place (same pixel, next sample) — its path radiance
        # folds into the lane's chunk accumulator and no flush row is
        # consumed. Only chunk completion holds. The per-channel clamp is
        # applied PER PATH at fold time, exactly as the reference
        # accumulator does per sample (program-raymarch.ts:283-285) — a
        # per-chunk clamp would let one path's negative channel cancel
        # another's positive one.
        died = st["alive"] & ~alive
        cont = died & (st["chunk_left"] > 1)
        finished = died & ~cont
        acc = st["acc"] + jnp.where(
            died[:, None], jnp.maximum(radiance, 0.0), 0.0
        )
        radiance = jnp.where(died[:, None], 0.0, radiance)

        # Terminated lanes *hold* their finished path until flushed. Each
        # group of W lanes flushes at most ONE held path per iteration — a
        # [B/W]-row image scatter instead of [B] rows, whose cost grows
        # with the row count. Lanes terminate at ~0.2/iter, below the
        # group's 1/W slot, so the hold queue drains; an unflushed lane
        # just respawns a little later. Whether this pays on the GPU's
        # atomic scatter is ROADMAP S3.
        holding = st["holding"] | finished
        # Group lane i with lanes i + k*B/W (W-way) via contiguous strided
        # slices (no [B] -> [B/W, W] relayout). The first holding lane of
        # each group flushes.
        group = b // _FLUSH_WAYS
        rad = acc  # per-path clamp already applied at fold time (above)
        taken = jnp.zeros((group,), bool)
        row_pix = jnp.full((group,), n_pixels, dtype=jnp.uint32)  # drop row
        row_val = jnp.zeros((group, 3), jnp.float32)
        sels = []
        for k in range(_FLUSH_WAYS):
            h_k = holding[k * group : (k + 1) * group]
            sel_k = h_k & ~taken
            taken = taken | sel_k
            row_pix = jnp.where(
                sel_k, st["pixel"][k * group : (k + 1) * group], row_pix
            )
            row_val = jnp.where(
                sel_k[:, None], rad[k * group : (k + 1) * group], row_val
            )
            sels.append(sel_k)
        selected = jnp.concatenate(sels)
        image = st["image"].at[row_pix].add(row_val, mode="drop")

        # Flushed lanes take fresh chunk-start ids from the global counter
        # (which counts ids, advancing K per chunk claimed).
        rank = jnp.cumsum(selected.astype(jnp.uint32)) - 1
        new_ids = st["next_id"] + rank * jnp.uint32(k_chunk)
        take = selected & (new_ids < limit)
        next_id = jnp.minimum(
            st["next_id"]
            + jnp.sum(selected.astype(jnp.uint32)) * jnp.uint32(k_chunk),
            limit,
        )

        n_pixel, n_sample, n_count = chunk_info(new_ids)
        # One camera-ray generation serves both respawn kinds: fresh
        # chunks (take) and in-chunk continuations (cont).
        r_pixel = jnp.where(take, n_pixel, st["pixel"])
        r_sample = jnp.where(take, n_sample, st["sample"] + 1)
        r_o, r_d = cam(r_pixel, r_sample)

        resp = take | cont
        sel = resp[:, None]
        return dict(
            o=jnp.where(sel, r_o, o),
            d=jnp.where(sel, r_d, d),
            beta=jnp.where(sel, 1.0, beta),
            radiance=radiance,
            acc=jnp.where(take[:, None], 0.0, acc),
            alive=alive | resp,
            holding=holding & ~selected,
            spec=jnp.where(resp, False, spec),
            pixel=r_pixel,
            sample=jnp.where(resp, r_sample, st["sample"]),
            depth=jnp.where(resp, 0, depth),
            chunk_left=jnp.where(
                take,
                n_count,
                jnp.where(cont, st["chunk_left"] - 1, st["chunk_left"]),
            ),
            image=image,
            next_id=next_id,
            n_rays=st["n_rays"] + n,
            iters=st["iters"] + 1,
        )

    state = jax.lax.while_loop(cond, body, state)
    return state["image"], state["n_rays"], state["iters"]


def render_regenerative_stats(scene, camera, settings):
    """Full render via the regenerative pool -> (mean radiance [H, W, 3],
    n_rays traced, pool iterations)."""
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    n_pixels = settings.width * settings.height
    image, n_rays, iters = render_pool(
        scene,
        frame,
        settings,
        n_pixels=n_pixels,
        batch=min(settings.batch_size, n_pixels * settings.samples_per_pixel),
        rays_per_pixel=settings.samples_per_pixel,
    )
    mean = image / settings.samples_per_pixel
    return mean.reshape(settings.height, settings.width, 3), n_rays, iters


def render_regenerative(scene, camera, settings):
    """Full render via the regenerative pool -> mean radiance [H, W, 3]."""
    return render_regenerative_stats(scene, camera, settings)[0]
