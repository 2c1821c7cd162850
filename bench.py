"""Benchmark harness: rays/sec/chip + MSE vs the reference ground truth.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, "mse": {...}}

Headline workload: CornellBox (procedural twin of scene_assets
CornellBox-Original), 512x512 spp16, full GI, rr=0.9, depth<=17, regen
scheduler — matching scene_files/final/cornell_box_full_lighting.ini. Ray
counts are the integrator's real live-lane counters, not grid size.

The reference publishes no numbers (BASELINE.md: "published": {}), so the
defensible metrics are absolute rays/s and MSE vs its ground-truth images
(`scene_assets/ground_truth/final/*.png`, pairing table
submission-final.md:20-27). ``device`` names the platform, device kind and
count, and the card's name and power limit as nvidia-smi reports them.

``--scene mesh`` renders the seeded large-mesh scene
(``procedural.mesh_scene``, ``--mesh-tris`` triangles) instead; with
``--intersector brute`` / ``shortlist`` it times the two sweeps on one mesh.

``--mse`` (default on when the reference assets exist) renders all six
final configs at their full 512x512 resolution and INI spp on the device
and reports per-config MSE against both ground_truth (instructor renderer)
and student_outputs (the reference code's own renders), plus the
BASELINE.json north-star point: CornellBox 512x512 @ 1024 spp.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

REFERENCE_ROOT = os.environ.get("PT_TPU_REFERENCE_ROOT", "/root/reference")

FINAL_CONFIGS = (
    "cornell_box_full_lighting",
    "cornell_box_direct_lighting_only",
    "cornell_box_full_lighting_low_probability",
    "mirror",
    "glossy",
    "refraction",
)


def _require_reference(path: str) -> None:
    if not os.path.exists(path):
        raise SystemExit(
            f"reference asset {path!r} not found; set PT_TPU_REFERENCE_ROOT "
            "to the reference checkout (or pass --no-mse / --scene cornell)"
        )


def _render_config_mse(name: str, spp_override: int | None = None):
    """Render one final config at full size/spp -> (mse_gt, mse_student,
    rays/s, wall_s, spp)."""
    import jax

    from pathtracer_tpu.models.scene import load_scene
    from pathtracer_tpu.ops.tonemap import tonemap_reference
    from pathtracer_tpu.ops.wavefront import render_regenerative_stats
    from pathtracer_tpu.utils.image import mse, read_png

    ini = os.path.join(REFERENCE_ROOT, "scene_files/final", name + ".ini")
    _require_reference(ini)
    overrides = {}
    if spp_override is not None:
        overrides["samples_per_pixel"] = spp_override
    scene, camera, settings, _ = load_scene(ini, **overrides)

    # Compile outside the timed region.
    mean, n_rays, _ = render_regenerative_stats(scene, camera, settings)
    jax.block_until_ready(mean)
    t0 = time.perf_counter()
    mean, n_rays, _ = render_regenerative_stats(scene, camera, settings)
    jax.block_until_ready(mean)
    wall = time.perf_counter() - t0

    img = jax.device_get(tonemap_reference(mean))
    out = {
        "rays_per_sec": round(float(n_rays) / wall, 1),
        "wall_s": round(wall, 3),
        "spp": settings.samples_per_pixel,
    }
    gt = os.path.join(REFERENCE_ROOT, "scene_assets/ground_truth/final", name + ".png")
    st = os.path.join(REFERENCE_ROOT, "student_outputs/final", name + ".png")
    if os.path.exists(gt):
        out["mse_ground_truth"] = round(mse(img, read_png(gt)), 6)
    if os.path.exists(st):
        out["mse_student_output"] = round(mse(img, read_png(st)), 6)
    return out


def device_info() -> dict:
    """Platform, device kind and count, plus the card's nvidia-smi name and
    power limit (None where nvidia-smi is absent)."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": None}
    try:
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument(
        "--scene",
        default="cornell",
        choices=("cornell", "boat", "mesh"),
        help="cornell: procedural CornellBox twin (36 tris); "
        "boat: MedievalBoat.xml large-mesh stressor (12.5k tris); "
        "mesh: seeded procedural mesh of --mesh-tris triangles",
    )
    p.add_argument("--mesh-tris", type=int, default=12_600)
    p.add_argument("--seed", type=int, default=0, help="mesh scene seed")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument(
        "--repeat", type=int, default=3,
        help="timed repetitions of the headline run; the best is reported",
    )
    p.add_argument("--intersector", default="auto")
    p.add_argument("--scheduler", default="regen", choices=("regen", "scan"))
    p.add_argument(
        "--spawn-chunk", type=int, default=None,
        help="override RenderSettings.spawn_chunk (samples per lane spawn)",
    )
    shard_group = p.add_mutually_exclusive_group()
    shard_group.add_argument(
        "--sharded", dest="sharded", action="store_true", default=None,
        help="also time the mesh-sharded regenerative pool over all "
        "devices and report per-device rays/s + efficiency vs the "
        "single-device number (on a 1-chip host this measures sharding "
        "overhead; on a multi-chip mesh, scaling efficiency)",
    )
    shard_group.add_argument("--no-sharded", dest="sharded", action="store_false")
    boat_group = p.add_mutually_exclusive_group()
    boat_group.add_argument(
        "--boat", dest="boat", action="store_true", default=None,
        help="also render the MedievalBoat large-mesh stressor and report "
        "its rays/s (BASELINE config 4)",
    )
    boat_group.add_argument("--no-boat", dest="boat", action="store_false")
    mse_group = p.add_mutually_exclusive_group()
    mse_group.add_argument(
        "--mse", dest="mse", action="store_true", default=None,
        help="render all six final configs full-size and report MSE",
    )
    mse_group.add_argument("--no-mse", dest="mse", action="store_false")
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a jax.profiler device trace of the timed region",
    )
    args = p.parse_args()

    from pathtracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.models.procedural import cornell_box_scene
    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.ops import rng
    from pathtracer_tpu.ops.camera_rays import generate_rays
    from pathtracer_tpu.ops.integrator import radiance_batch_stats
    from pathtracer_tpu.utils.profiling import trace

    if args.scene == "boat":
        from pathtracer_tpu.models.scene import scene_from_graph
        from pathtracer_tpu.models.scenegraph import load_scenegraph

        boat_xml = os.path.join(REFERENCE_ROOT, "scene_assets/MedievalBoat.xml")
        _require_reference(boat_xml)
        graph = load_scenegraph(boat_xml)
        scene, camera = scene_from_graph(
            graph, os.path.join(REFERENCE_ROOT, "scene_assets")
        )
    elif args.scene == "mesh":
        from pathtracer_tpu.models.procedural import mesh_scene

        scene, camera = mesh_scene(args.mesh_tris, args.seed)
    else:
        scene, camera = cornell_box_scene()
    extra = {}
    if args.spawn_chunk is not None:
        extra["spawn_chunk"] = args.spawn_chunk
    settings = RenderSettings(
        width=args.size,
        height=args.size,
        samples_per_pixel=args.spp,
        intersector=args.intersector,
        scheduler=args.scheduler,
        **extra,
    )
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(args.size, args.size).items()
    }
    n_pixels = args.size * args.size
    pixel_ids = jnp.arange(n_pixels, dtype=jnp.uint32)

    import contextlib
    import functools

    @functools.partial(jax.jit, static_argnames=())
    def wave(scene, frame, sample_idx):
        sample_ids = jnp.full((n_pixels,), sample_idx, dtype=jnp.uint32)
        jitter = rng.pixel_jitter_hash(pixel_ids, sample_ids)
        o, d = generate_rays(frame, args.size, args.size, pixel_ids, jitter)
        rad, n_rays = radiance_batch_stats(
            scene, settings, o, d, pixel_ids, sample_ids
        )
        return jnp.maximum(rad, 0.0), n_rays

    traced = trace(args.trace) if args.trace else contextlib.nullcontext()

    if args.scheduler == "regen":
        from pathtracer_tpu.ops.wavefront import render_pool

        def run():
            img, n_rays, iters = render_pool(
                scene,
                frame,
                settings,
                n_pixels=n_pixels,
                batch=min(settings.batch_size, n_pixels * args.spp),
                rays_per_pixel=args.spp,
            )
            jax.block_until_ready(img)
            return float(n_rays)

        t0 = time.perf_counter()
        run()  # compile
        first_s = time.perf_counter() - t0
        with traced:
            dt = float("inf")
            for _ in range(max(1, args.repeat)):
                t0 = time.perf_counter()
                total_rays = run()
                dt = min(dt, time.perf_counter() - t0)
    else:
        first_s = None
        # Warmup (compile) then timed samples.
        for s in range(args.warmup):
            r, n = wave(scene, frame, jnp.uint32(s))
            jax.block_until_ready(r)

        acc = jnp.zeros((n_pixels, 3))
        total_rays = 0.0
        with traced:
            t0 = time.perf_counter()
            for s in range(args.spp):
                r, n = wave(scene, frame, jnp.uint32(s))
                acc = acc + r
            jax.block_until_ready(acc)
            dt = time.perf_counter() - t0
        # Ray counts are deterministic per sample; fetch after timing.
        for s in range(args.spp):
            _, n = wave(scene, frame, jnp.uint32(s))
            total_rays += float(n)

    rays_per_sec = total_rays / dt
    from pathtracer_tpu.ops.intersect import resolve_intersector

    result = {
        "metric": "rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "workload": f"{args.scene}_{args.size}x{args.size}_spp{args.spp}",
        "tris": scene.num_tris,
        "padded_tris": scene.padded_tris,
        "paths_per_sec": round(n_pixels * args.spp / dt, 1),
        "wall_s": round(dt, 4),
        "first_call_s": first_s,
        "device": device_info(),
        "intersector": resolve_intersector(settings, scene),
        "scheduler": args.scheduler,
    }
    if args.trace:
        # Scope shares need per-kernel events: run with
        # XLA_FLAGS=--xla_gpu_enable_command_buffer= so that XLA does not
        # fold the loop body into one CUDA-graph event.
        from pathtracer_tpu.ops.intersect import CLOSEST_SCOPE, SHADOW_SCOPE
        from pathtracer_tpu.utils.profiling import (
            hlo_op_names, latest_xplane, trace_summary,
        )

        op_names = None
        if args.scheduler == "regen":
            op_names = hlo_op_names(render_pool.lower(
                scene, frame, settings, n_pixels=n_pixels,
                batch=min(settings.batch_size, n_pixels * args.spp),
                rays_per_pixel=args.spp,
            ).compile().as_text())
        result["trace_dir"] = args.trace
        result["trace"] = trace_summary(
            latest_xplane(args.trace), op_names,
            scopes=(CLOSEST_SCOPE, SHADOW_SCOPE),
        )

    do_sharded = args.sharded
    if do_sharded is None:
        do_sharded = args.scene == "cornell" and args.scheduler == "regen"
    if do_sharded:
        from pathtracer_tpu.parallel.render import render_pool_sharded_stats

        n_dev = jax.device_count()
        mean_s, rays_s, _ = render_pool_sharded_stats(scene, camera, settings)
        jax.block_until_ready(mean_s)  # compile
        dt_s = float("inf")
        for _ in range(max(1, args.repeat)):
            t0 = time.perf_counter()
            mean_s, rays_s, _ = render_pool_sharded_stats(scene, camera, settings)
            jax.block_until_ready(mean_s)
            dt_s = min(dt_s, time.perf_counter() - t0)
        rps_total = float(rays_s) / dt_s
        per_dev = rps_total / n_dev

        # Weak-scaling denominator through the SAME code path: a 1-device
        # mesh running ~1/n_dev of the work (ceil(spp / n_dev) samples).
        # On a 1-chip host that is the sharded run itself, so efficiency
        # is 1.0 by construction; on several cards, deviations measure
        # communication and load imbalance. (A plain-jit denominator is
        # not comparable: the shard_map-wrapped pool compiles to a
        # different program, so cross-code-path ratios can read as fake
        # super-efficiency.)
        if n_dev == 1:
            denom_rps = per_dev
        else:
            import dataclasses

            from pathtracer_tpu.parallel.mesh import make_mesh

            d_settings = dataclasses.replace(
                settings, samples_per_pixel=-(-args.spp // n_dev)
            )
            mesh1 = make_mesh(jax.devices()[:1])
            mean_d, rays_d, _ = render_pool_sharded_stats(
                scene, camera, d_settings, mesh=mesh1
            )
            jax.block_until_ready(mean_d)  # compile
            dt_d = float("inf")
            for _ in range(max(1, args.repeat)):
                t0 = time.perf_counter()
                mean_d, rays_d, _ = render_pool_sharded_stats(
                    scene, camera, d_settings, mesh=mesh1
                )
                jax.block_until_ready(mean_d)
                dt_d = min(dt_d, time.perf_counter() - t0)
            denom_rps = float(rays_d) / dt_d
        result["sharded"] = {
            "n_devices": n_dev,
            "rays_per_sec": round(rps_total, 1),
            "rays_per_sec_per_device": round(per_dev, 1),
            "single_device_same_work_rays_per_sec": round(denom_rps, 1),
            # Weak-scaling efficiency (fixed work per device, same code
            # path): per-device sharded throughput vs a 1-device mesh
            # running a 1/n_dev-work slice.
            "efficiency": round(per_dev / denom_rps, 3),
        }

    do_boat = args.boat
    if do_boat is None:
        do_boat = args.scene == "cornell" and os.path.exists(
            os.path.join(REFERENCE_ROOT, "scene_assets/MedievalBoat.xml")
        )
    if do_boat:
        from pathtracer_tpu.models.scene import scene_from_graph
        from pathtracer_tpu.models.scenegraph import load_scenegraph
        from pathtracer_tpu.ops.wavefront import render_regenerative_stats

        graph = load_scenegraph(
            os.path.join(REFERENCE_ROOT, "scene_assets/MedievalBoat.xml")
        )
        b_scene, b_camera = scene_from_graph(
            graph, os.path.join(REFERENCE_ROOT, "scene_assets")
        )
        b_settings = RenderSettings(
            width=512, height=512, samples_per_pixel=4,
            intersector=args.intersector,
        )
        mean_b, rays_b, _ = render_regenerative_stats(b_scene, b_camera, b_settings)
        jax.block_until_ready(mean_b)  # compile
        dt_b = float("inf")
        for _ in range(max(1, args.repeat)):
            t0 = time.perf_counter()
            mean_b, rays_b, _ = render_regenerative_stats(b_scene, b_camera, b_settings)
            jax.block_until_ready(mean_b)
            dt_b = min(dt_b, time.perf_counter() - t0)
        result["large_scene"] = {
            "workload": "medieval_boat_512x512_spp4",
            "tris": b_scene.num_tris,
            "rays_per_sec": round(float(rays_b) / dt_b, 1),
            "wall_s": round(dt_b, 3),
            "intersector": args.intersector,
        }

    do_mse = args.mse
    if do_mse is None:
        do_mse = args.scene == "cornell" and os.path.exists(
            os.path.join(REFERENCE_ROOT, "scene_assets/ground_truth/final")
        )
    if do_mse:
        mse_out = {}
        for name in FINAL_CONFIGS:
            mse_out[name] = _render_config_mse(name)
        # BASELINE.json north-star point: CornellBox 512^2 @ 1024 spp.
        mse_out["cornell_box_full_lighting_spp1024"] = _render_config_mse(
            "cornell_box_full_lighting", spp_override=1024
        )
        result["mse"] = mse_out

    print(json.dumps(result))


if __name__ == "__main__":
    main()
