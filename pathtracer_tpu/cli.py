"""Command-line renderer.

Replaces the reference's browser shell + hardcoded scene path
(``src/index.ts:15-24`` — a commented-in/out path list) with a real CLI:

    python -m pathtracer_tpu.cli scene_files/final/cornell_box_full_lighting.ini \
        --scene-root /root/reference --out out.png

The INI's ``output`` path is honored (the reference parses it at
``parse-ini.ts:39`` but never writes a file).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    from pathtracer_tpu.models.scene import INTERSECTORS

    p = argparse.ArgumentParser(description="JAX path tracer")
    p.add_argument("ini", help="render config (.ini)")
    p.add_argument("--scene-root", default=None, help="root for /scene_assets refs")
    p.add_argument("--out", default=None, help="output PNG (default: INI output)")
    p.add_argument("--spp", type=int, default=None, help="override samplesPerPixel")
    p.add_argument("--size", type=int, default=None, help="override square resolution")
    p.add_argument(
        "--intersector",
        default="auto",
        choices=INTERSECTORS,
        help="auto = Triton sweep kernel for small scenes on a GPU, else "
        "the XLA brute sweep; shortlist = block-shortlist; bvh = "
        "traversal oracle",
    )
    p.add_argument(
        "--seed", type=int, default=0,
        help="RNG stream seed (0 = the goldens' stream)",
    )
    p.add_argument("--tonemap", default="reference")
    p.add_argument(
        "--scheduler", default="regen", choices=("regen", "scan"),
        help="regen = regenerative wavefront pool (fastest); scan = "
        "fixed-depth wave per sample — the differentiable path, ~4x slower",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="path for resumable accumulation state (.npz)",
    )
    p.add_argument(
        "--preview-png", type=int, default=0, metavar="N",
        help="write the tonemapped partial image every N samples "
        "(<out>.preview_NNNN.png) — the reference displays every "
        "accumulated frame (program-raymarch.ts:277-318)",
    )
    p.add_argument(
        "--serve", type=int, default=0, metavar="PORT",
        help="serve a live auto-refreshing preview of the accumulating "
        "render at http://127.0.0.1:PORT/ while rendering — the CLI "
        "equivalent of the reference's per-frame canvas display "
        "(program-raymarch.ts:317-318)",
    )
    p.add_argument("--sharded", action="store_true", help="shard over all devices")
    p.add_argument(
        "--light-sampling",
        default="compat",
        choices=("compat", "area"),
        help="compat = reference's count-based light pdf; area = corrected",
    )
    p.add_argument(
        "--shadow-mode",
        default="fast",
        choices=("fast", "closest"),
        help="fast = t-only occlusion sweep; closest = reference semantics",
    )
    p.add_argument(
        "--glossy-brdf",
        default="phong",
        choices=("phong", "beckmann"),
        help="glossy lobe: reference Phong, or corrected Beckmann microfacet",
    )
    args = p.parse_args(argv)

    from pathtracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from pathtracer_tpu.models.scene import load_scene
    from pathtracer_tpu.utils.image import write_png

    overrides = dict(
        intersector=args.intersector,
        scheduler=args.scheduler,
        shadow_mode=args.shadow_mode,
        glossy_brdf=args.glossy_brdf,
        seed=args.seed,
    )
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.size is not None:
        overrides["width"] = args.size
        overrides["height"] = args.size
    if args.light_sampling == "area":
        overrides["compat_count_light_pdf"] = False

    scene, camera, settings, ini = load_scene(
        args.ini, scene_root=args.scene_root, **overrides
    )
    print(
        f"scene: {ini.scene} | {scene.num_tris} tris "
        f"({scene.padded_tris} padded), {scene.num_analytic} analytic prims, "
        f"BVH depth {scene.bvh_depth}"
    )
    print(
        f"render: {settings.width}x{settings.height} @ "
        f"{settings.samples_per_pixel} spp, rr={settings.rr_prob}, "
        f"direct_only={settings.direct_lighting_only}"
    )

    def progress(done, total):
        if done % max(1, total // 10) == 0 or done == total:
            print(f"  sample {done}/{total}", file=sys.stderr)

    out = args.out or ini.output or "render.png"
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    server = None
    if args.serve:
        from pathtracer_tpu.utils.preview_server import PreviewServer

        server = PreviewServer(port=args.serve)
        print(
            f"live preview: http://127.0.0.1:{server.port}/", file=sys.stderr
        )

    def preview(done_spp, mean):
        import jax

        from pathtracer_tpu.ops.tonemap import TONEMAPS
        from pathtracer_tpu.utils.image import to_uint8

        img = jax.device_get(TONEMAPS[args.tonemap](mean))
        if args.preview_png:
            stem, ext = os.path.splitext(out)
            path = f"{stem}.preview_{done_spp:04d}{ext or '.png'}"
            write_png(path, img)
            print(f"  preview {done_spp} spp -> {path}", file=sys.stderr)
        if server is not None:
            server.update(
                to_uint8(img), done_spp, settings.samples_per_pixel
            )

    t0 = time.perf_counter()
    if args.checkpoint:
        import jax

        from pathtracer_tpu.ops.tonemap import TONEMAPS
        from pathtracer_tpu.render import render_checkpointed

        mean = render_checkpointed(
            scene, camera, settings, args.checkpoint, progress_callback=progress
        )
        img = jax.device_get(TONEMAPS[args.tonemap](mean))
    elif args.sharded:
        import jax

        from pathtracer_tpu.ops.tonemap import TONEMAPS
        from pathtracer_tpu.parallel.render import (
            render_pool_sharded,
            render_sharded,
        )

        if settings.scheduler == "regen":
            mean = render_pool_sharded(scene, camera, settings)
        else:
            mean = render_sharded(
                scene, camera, settings, progress_callback=progress
            )
        img = jax.device_get(TONEMAPS[args.tonemap](mean))
    else:
        from pathtracer_tpu.render import render_image

        preview_every = args.preview_png or (1 if server is not None else 0)
        img = render_image(
            scene, camera, settings, tonemap=args.tonemap,
            progress_callback=progress,
            preview_every=preview_every,
            preview_fn=preview if preview_every else None,
        )
    dt = time.perf_counter() - t0

    n_rays = settings.width * settings.height * settings.samples_per_pixel
    print(f"rendered in {dt:.2f}s ({n_rays / dt / 1e6:.2f} Mpaths/s)")

    write_png(out, img)
    print(f"wrote {out}")
    if server is not None:
        from pathtracer_tpu.utils.image import to_uint8

        server.update(
            to_uint8(img), settings.samples_per_pixel,
            settings.samples_per_pixel, done=True,
        )
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
