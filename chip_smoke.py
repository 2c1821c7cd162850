#!/usr/bin/env python3
"""Bring-up check: the path tracer's main paths on the GPU, at full size.

    python3 chip_smoke.py               # phases 1-4 on one card
    python3 chip_smoke.py --devices 4   # phase 1, then only the 4-card phase
    python3 chip_smoke.py --trace DIR   # also trace the final frame's pool

Phases, each through the public API and checked against the repo's plain
reference (the ``scan`` scheduler with the ``brute`` sweep, at float32
``highest`` matmul precision):

1. device: the default device must be a GPU. There is no CPU fallback.
2. final frame: CornellBox 512x512, 50 spp, rr 0.9, depth 17 (the
   reference's final configuration) through the regenerative pool with
   ``auto`` routing (the Triton ``sweep`` kernel), against the scan/brute
   reference render.
3. large mesh: a seeded ~12.6k-triangle mesh (``procedural.mesh_scene``):
   the block-shortlist's closest hit and occlusion must equal the brute
   sweep exactly on 2^16 mixed camera and bounce rays; a 512x512, 4 spp
   frame through ``auto`` (brute) and a 128x128, 4 spp frame through the
   shortlist with the pool ray sort must render finite.
4. inverse: 5 path-replay Adam steps on albedo at 128x128, depth 6, from
   perturbed materials toward a target from the true ones (the image loss
   must fall), and the first gradient at 64x64 against the same gradient
   computed on the host CPU.
5. ``--devices N``: the regenerative pool sharded over N cards against the
   one-card pool, and one sharded train step against the unsharded one.

Every phase prints one ``PHASE {json}`` line with the card, the resolved
intersector, compile and wall seconds, rays/s and each error beside its
tolerance. A failed check raises, so the exit code is non-zero and the
final line is missing. The final line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# Phase 2 and 5 tolerances. Both renders trace the same paths (the counter
# RNG fixes every random draw), so they differ only in float summation
# order: atomics in the image scatter-add, and a different fusion (and
# FMA contraction) per program. A ray landing exactly on a shared edge may
# then pick the other triangle, changing that one path.
PIXEL_RTOL = 1e-4  # per-pixel relative difference ...
PIXEL_FRAC = 0.999  # ... met by at least this share of pixels
MEAN_RTOL = 1e-5  # image mean, relative
# Phase 4: the GPU and the host CPU evaluate sin/cos/sqrt with different
# libraries, so a few of the 4096 paths may cross a triangle edge
# differently; each such path moves about 1/4096 of the gradient.
GRAD_RTOL = 1e-2  # relative L2 distance of the two gradients
# Phase 5 train step: the same edge crossings move the 4096-pixel mean loss
# by about 1/4096 of one pixel's error each.
LOSS_RTOL = 1e-3


def card_name() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def _emit(phase: str, **fields) -> dict:
    rec = {"phase": phase, **fields}
    print("PHASE " + json.dumps(rec), flush=True)
    return rec


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def image_agreement(img, ref) -> dict:
    """Phase 2/5 comparison of two renders of the same paths."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    _check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    _check(bool(np.isfinite(a).all() and np.isfinite(b).all()), "NaN/inf")
    within = np.abs(a - b) <= PIXEL_RTOL * np.maximum(np.abs(b), 1e-3)
    frac = float(within.all(axis=-1).mean())
    mean_rel = float(abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-30))
    out = {
        "pixels_within": frac, "pixels_within_tol": PIXEL_FRAC,
        "pixel_rtol": PIXEL_RTOL,
        "mean_rel_err": mean_rel, "mean_rel_tol": MEAN_RTOL,
        "max_abs_err": float(np.abs(a - b).max()),
        "mean": float(a.mean()),
    }
    _check(frac >= PIXEL_FRAC and mean_rel <= MEAN_RTOL,
           f"renders disagree: {out}")
    return out


def _frame(camera, settings):
    import jax.numpy as jnp

    return {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }


def _memory(compiled) -> dict:
    mem = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(mem, k, None) for k in keys}


def phase_device(require: str = "gpu") -> dict:
    """Phase 1 -> {"platform", "kind", "count"} of the default backend."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != require:
        raise SystemExit(f"chip_smoke: needs a {require} device, found {info}")
    return info


def phase_final_frame(card: str, size: int = 512, spp: int = 50,
                      depth: int = 17, trace_dir: str | None = None) -> dict:
    """Phase 2: the final frame through ``render_image`` vs the reference."""
    import jax

    from pathtracer_tpu.models.procedural import cornell_box_scene
    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.ops.intersect import (
        CLOSEST_SCOPE, SHADOW_SCOPE, resolve_intersector,
    )
    from pathtracer_tpu.ops.wavefront import (
        render_pool, render_regenerative_stats,
    )
    from pathtracer_tpu.render import render_image

    scene, camera = cornell_box_scene()
    settings = RenderSettings(width=size, height=size, samples_per_pixel=spp,
                              max_depth=depth, rr_prob=0.9)
    method = resolve_intersector(settings, scene)
    _check(method in ("brute", "sweep"),
           f"auto chose {method!r} for the Cornell box")

    n_pixels = size * size
    t0 = time.perf_counter()
    compiled = render_pool.lower(
        scene, _frame(camera, settings), settings, n_pixels=n_pixels,
        batch=min(settings.batch_size, n_pixels * spp), rays_per_pixel=spp,
    ).compile()
    compile_s = time.perf_counter() - t0
    mem = _memory(compiled)

    t0 = time.perf_counter()
    img = render_image(scene, camera, settings)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, n_rays, iters = render_regenerative_stats(scene, camera, settings)
    jax.block_until_ready(mean)
    wall_s = time.perf_counter() - t0

    trace = None
    if trace_dir:
        from pathtracer_tpu.utils.profiling import (
            hlo_op_names, latest_xplane, trace as profile, trace_summary,
        )

        with profile(trace_dir):
            jax.block_until_ready(
                render_regenerative_stats(scene, camera, settings)[0]
            )
        trace = trace_summary(
            latest_xplane(trace_dir), hlo_op_names(compiled.as_text()),
            scopes=(CLOSEST_SCOPE, SHADOW_SCOPE),
        )
        trace["iterations"] = int(iters)
        with open(os.path.join(trace_dir, "summary.json"), "w") as f:
            json.dump(trace, f, indent=1)

    ref_settings = dataclasses.replace(settings, scheduler="scan",
                                       intersector="brute")
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ref = render_image(scene, camera, ref_settings)
    ref_s = time.perf_counter() - t0

    err = image_agreement(img, ref)
    rec = _emit(
        "final_frame", card=card, intersector=method,
        workload=f"cornell {size}x{size} spp{spp} depth{depth} rr0.9",
        compile_s=compile_s, first_call_s=first_s, wall_s=wall_s,
        rays=float(n_rays), rays_per_s=float(n_rays) / wall_s,
        iterations=int(iters), reference_s_incl_compile=ref_s,
        memory_analysis=mem, **err,
    )
    if trace is not None:
        print("TRACE " + json.dumps(trace), flush=True)
    return rec


def mixed_rays(scene, camera, n: int, seed: int = 0):
    """n/2 camera rays and n/2 bounce rays (leaving the camera rays' brute
    hit points in seeded random directions) -> (o [n, 3], d [n, 3])."""
    import jax.numpy as jnp

    from pathtracer_tpu.ops import rng
    from pathtracer_tpu.ops.camera_rays import generate_rays
    from pathtracer_tpu.ops.intersect import closest_tri_brute

    w = min(256, n // 2)
    h = n // 2 // w
    ids = jnp.arange(w * h, dtype=jnp.uint32)
    jitter = rng.pixel_jitter_hash(ids, ids * 0)
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(w, h).items()}
    o_cam, d_cam = generate_rays(frame, w, h, ids, jitter)
    t, _ = closest_tri_brute(scene, o_cam, d_cam)
    t = np.asarray(t)
    hit = np.isfinite(t)
    p = np.asarray(o_cam) + np.where(hit, t * 0.999, 0.0)[:, None] * np.asarray(d_cam)
    d_new = np.random.default_rng(seed).normal(size=p.shape)
    d_new /= np.linalg.norm(d_new, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o_cam), p]).astype(np.float32)
    d = np.concatenate([np.asarray(d_cam), d_new]).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _timed_render(scene, camera, settings):
    """(first-call s, second-call s, mean image, rays, iterations)."""
    import jax

    from pathtracer_tpu.ops.wavefront import render_regenerative_stats

    t0 = time.perf_counter()
    jax.block_until_ready(render_regenerative_stats(scene, camera, settings)[0])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, rays, iters = render_regenerative_stats(scene, camera, settings)
    mean = np.asarray(mean)
    wall_s = time.perf_counter() - t0
    _check(bool(np.isfinite(mean).all()) and mean.mean() > 0.0,
           f"render not finite/lit: {settings}")
    return first_s, wall_s, mean, float(rays), int(iters)


def phase_large_mesh(card: str, size: int = 512, spp: int = 4,
                     n_tris: int = 12_600, n_rays: int = 1 << 16,
                     seed: int = 0, sort_size: int = 128) -> dict:
    """Phase 3: a seeded large mesh through auto and through the shortlist."""
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.models.procedural import mesh_scene
    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.ops.intersect import (
        closest_tri_brute, resolve_intersector,
    )
    from pathtracer_tpu.ops.intersect_shortlist import (
        closest_tri_shortlist, occluded_tri_shortlist,
    )
    from pathtracer_tpu.ops.wavefront import render_pool

    scene, camera = mesh_scene(n_tris, seed)
    settings = RenderSettings(width=size, height=size, samples_per_pixel=spp)
    method = resolve_intersector(settings, scene)

    o, d = mixed_rays(scene, camera, n_rays, seed)
    t_b, id_b = (np.asarray(a) for a in jax.jit(closest_tri_brute)(scene, o, d))
    t_s, id_s = (np.asarray(a) for a in closest_tri_shortlist(scene, o, d))
    hit = np.isfinite(t_b)
    t_cut = jnp.asarray(
        np.random.default_rng(seed + 1).uniform(0.05, 3.0, n_rays), jnp.float32
    )
    occ_s = np.asarray(occluded_tri_shortlist(scene, o, d, t_cut))
    occ_b = t_b < np.asarray(t_cut)
    exact = {
        "t_mismatches": int((t_b != t_s).sum()),
        "id_mismatches_on_hits": int((id_b[hit] != id_s[hit]).sum()),
        "occlusion_mismatches": int((occ_b != occ_s).sum()),
        "hit_share": float(hit.mean()),
        "tolerance": "exact (0 mismatches)",
    }
    _check(exact["t_mismatches"] == 0 and exact["id_mismatches_on_hits"] == 0
           and exact["occlusion_mismatches"] == 0,
           f"shortlist != brute: {exact}")

    first_s, wall_s, mean, rays, iters = _timed_render(scene, camera, settings)

    # The shortlist route with the pool ray sort, at a smaller frame.
    sl = dataclasses.replace(settings, width=sort_size, height=sort_size,
                             intersector="shortlist")
    n_pixels = sort_size * sort_size
    lowered = render_pool.lower(
        scene, _frame(camera, sl), sl, n_pixels=n_pixels,
        batch=min(sl.batch_size, n_pixels * spp), rays_per_pixel=spp,
    )
    _check("sort" in lowered.as_text(), "pool ray sort not in the program")
    sl_first, sl_wall, sl_mean, sl_rays, _ = _timed_render(scene, camera, sl)
    return _emit(
        "large_mesh", card=card, intersector=method,
        workload=f"mesh {scene.num_tris} tris ({scene.padded_tris} padded) "
        f"{size}x{size} spp{spp} depth{settings.max_depth}",
        compile_s=first_s - wall_s, first_call_s=first_s, wall_s=wall_s,
        rays=rays, rays_per_s=rays / wall_s, iterations=iters,
        mean=float(mean.mean()),
        shortlist_sorted=f"{sort_size}x{sort_size} spp{spp}",
        shortlist_compile_s=sl_first - sl_wall, shortlist_wall_s=sl_wall,
        shortlist_rays_per_s=sl_rays / sl_wall,
        n_check_rays=n_rays, **exact,
    )


def phase_inverse(card: str, size: int = 128, depth: int = 6, steps: int = 5,
                  grad_size: int = 64, samples_per_step: int = 4) -> dict:
    """Phase 4: path-replay Adam steps, and the gradient against the CPU."""
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.inverse import (
        material_params, pixel_loss, recover_materials,
    )
    from pathtracer_tpu.models.procedural import cornell_box_scene
    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.ops.intersect import resolve_intersector
    from pathtracer_tpu.render import render

    scene, camera = cornell_box_scene()
    settings = RenderSettings(width=size, height=size, samples_per_pixel=16,
                              max_depth=depth, scheduler="scan")
    target = render(scene, camera, settings)
    pert = scene.replace(mat_Kd=scene.mat_Kd * 0.5)

    stamps = [time.perf_counter()]
    params, losses = recover_materials(
        pert, camera, settings, target, steps=steps, learning_rate=0.05,
        fields=("mat_Kd",), samples_per_step=samples_per_step,
        callback=lambda *_: stamps.append(time.perf_counter()),
    )
    step_s = np.diff(stamps)
    _check(bool(np.isfinite(losses).all()), f"non-finite loss {losses}")
    # The per-step losses carry each step's own Monte Carlo noise. The
    # check is the image error of the start and end albedo rendered with
    # the target's own sample ids: common random numbers leave the albedo
    # as the only difference, so the fall is not noise.
    eval_loss = [
        float(np.mean((np.asarray(render(sc, camera, settings))
                       - np.asarray(target)) ** 2))
        for sc in (pert, pert.replace(mat_Kd=params["mat_Kd"]))
    ]
    _check(bool(np.isfinite(eval_loss).all()) and eval_loss[1] < eval_loss[0],
           f"loss did not fall: {eval_loss}")
    kd_err = [float(np.abs(np.asarray(p) - np.asarray(scene.mat_Kd))[:3].max())
              for p in (pert.mat_Kd, params["mat_Kd"])]

    # First-step gradient (albedo, perturbed start) on the card and on the
    # host CPU: same paths, same counter RNG.
    gs = dataclasses.replace(settings, width=grad_size, height=grad_size,
                             samples_per_pixel=1)
    n = grad_size * grad_size
    args = (
        material_params(pert, ("mat_Kd",)), pert, _frame(camera, gs),
        jnp.asarray(target)[::size // grad_size, ::size // grad_size]
        .reshape(n, 3),
        jnp.arange(n, dtype=jnp.uint32), jnp.zeros((n,), jnp.uint32),
    )
    grad = jax.jit(jax.grad(
        lambda p, sc, fr, t, px, sm: pixel_loss(p, sc, gs, fr, t, px, sm)
    ))
    g_dev = np.asarray(grad(*args)["mat_Kd"], np.float64)
    cpu = jax.devices("cpu")[0]
    g_cpu = np.asarray(
        grad(*jax.device_put(args, cpu))["mat_Kd"], np.float64
    )
    grad_rel = float(np.linalg.norm(g_dev - g_cpu) / np.linalg.norm(g_cpu))
    _check(grad_rel <= GRAD_RTOL, f"gradient vs CPU: {grad_rel}")
    paths = 2 * samples_per_step * size * size
    return _emit(
        "inverse", card=card,
        intersector=resolve_intersector(settings, scene),
        workload=f"cornell {size}x{size} depth{depth} albedo, "
        f"{samples_per_step} spp x 2 waves per step",
        compile_s=float(step_s[0] - np.median(step_s[1:])),
        wall_s=float(np.median(step_s[1:])),
        paths_per_s=paths / float(np.median(step_s[1:])),
        rays_per_s="not counted (the train step reports no ray counter)",
        step_losses=[float(v) for v in losses],
        eval_loss_start_end=eval_loss,
        kd_max_err_start_end=kd_err,
        grad_rel_err_vs_cpu=grad_rel, grad_rel_tol=GRAD_RTOL,
        grad_size=f"{grad_size}x{grad_size}",
    )


def phase_sharded(card: str, n_devices: int, size: int = 512, spp: int = 16,
                  train_size: int = 64) -> dict:
    """Phase 5: sharded pool and train step against one device."""
    import jax
    import jax.numpy as jnp
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.models.procedural import cornell_box_scene
    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.ops.intersect import resolve_intersector
    from pathtracer_tpu.ops.wavefront import render_regenerative_stats
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded_stats

    devices = jax.devices()[:n_devices]
    _check(len(devices) == n_devices,
           f"need {n_devices} devices, have {len(jax.devices())}")
    mesh = make_mesh(devices)
    scene, camera = cornell_box_scene()
    settings = RenderSettings(width=size, height=size, samples_per_pixel=spp,
                              max_depth=17, scheduler="regen")

    t0 = time.perf_counter()
    jax.block_until_ready(
        render_pool_sharded_stats(scene, camera, settings, mesh=mesh)[0]
    )
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded, rays, _ = render_pool_sharded_stats(scene, camera, settings,
                                                  mesh=mesh)
    jax.block_until_ready(sharded)
    wall_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    jax.block_until_ready(render_regenerative_stats(scene, camera, settings)[0])
    single_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single, rays1, _ = render_regenerative_stats(scene, camera, settings)
    jax.block_until_ready(single)
    single_s = time.perf_counter() - t0
    err = image_agreement(sharded, single)

    # One sharded train step vs the same step on one device.
    ts = RenderSettings(width=train_size, height=train_size,
                        samples_per_pixel=1, max_depth=6)
    n = train_size * train_size
    frame = _frame(camera, ts)
    params = material_params(scene)
    opt = optax.adam(1e-2)
    step_args = (
        jnp.zeros((n, 3), jnp.float32), jnp.arange(n, dtype=jnp.uint32),
        jnp.zeros((n,), jnp.uint32), jnp.ones((n,), jnp.uint32),
    )
    _, _, loss_m = make_train_step(ts, opt, mesh=mesh)(
        params, opt.init(params), scene, frame, *step_args
    )
    _, _, loss_1 = make_train_step(ts, opt)(
        params, opt.init(params), scene, frame, *step_args
    )
    loss_rel = float(abs(float(loss_m) - float(loss_1)) / abs(float(loss_1)))
    _check(bool(np.isfinite(float(loss_m))) and loss_rel <= LOSS_RTOL,
           f"sharded train step loss {loss_m} vs {loss_1}")
    return _emit(
        "sharded", card=card, intersector=resolve_intersector(settings, scene),
        workload=f"cornell {size}x{size} spp{spp} depth17 over {n_devices} "
        "devices",
        compile_s=first_s - wall_s, wall_s=wall_s,
        rays=float(rays), rays_per_s=float(rays) / wall_s,
        single_device_wall_s=single_s,
        single_device_compile_s=single_first_s - single_s,
        single_device_rays_per_s=float(rays1) / single_s,
        train_loss_sharded=float(loss_m), train_loss_single=float(loss_1),
        train_loss_rel_err=loss_rel, train_loss_rel_tol=LOSS_RTOL, **err,
    )


def _allow_host_backend() -> None:
    """Keep the CPU backend reachable beside the GPU (phase 4 compares
    against it) when JAX_PLATFORMS names only accelerators."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1,
                   help="N > 1: run only the sharded phase over N cards")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="trace one final-frame pool run into DIR")
    args = p.parse_args(argv)

    _allow_host_backend()
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = phase_device("gpu")
    card = card_name()
    print(f"card: {card}", flush=True)
    print(f"device: {json.dumps(info)}", flush=True)

    if args.devices > 1:
        phase_sharded(card, args.devices)
    else:
        phase_final_frame(card, trace_dir=args.trace)
        phase_large_mesh(card)
        phase_inverse(card)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
