"""High-level rendering API.

Replacement for the reference's render loop
(``src/program-raymarch.ts:226-336``): where the reference dispatches one
1-spp frame per ``requestAnimationFrame`` and averages on the CPU, this jits
one sample-wave over the full pixel batch and accumulates on device.
Progressive accumulation (sample-at-a-time) is kept — it is what makes
renders checkpointable/resumable (``utils.checkpoint``) and is how spp maps
to the reference's frame loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pathtracer_tpu.models.camera import Camera
from pathtracer_tpu.models.scene import RenderSettings, Scene
from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.camera_rays import generate_rays
from pathtracer_tpu.ops.integrator import radiance_batch
from pathtracer_tpu.ops.tonemap import TONEMAPS


@functools.partial(jax.jit, static_argnames=("settings",))
def sample_wave(scene: Scene, frame: dict, settings: RenderSettings, sample_idx):
    """Trace one sample for every pixel -> [H*W, 3] radiance.

    Equivalent of one reference frame dispatch (1 new sample/pixel,
    program-raymarch.ts:255-260), with the per-frame time-seed RNG replaced
    by counter-based keys (pixel, sample) — see ops.rng.
    """
    n_pixels = settings.width * settings.height
    pixel_ids = jnp.arange(n_pixels, dtype=jnp.uint32)
    sample_ids = jnp.full((n_pixels,), sample_idx, dtype=jnp.uint32)

    jitter = rng.pixel_jitter(settings, pixel_ids, sample_ids)
    o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
    radiance = radiance_batch(scene, settings, o, d, pixel_ids, sample_ids)
    # Reference clamps each sample's channels at accumulation
    # (program-raymarch.ts:283-285).
    return jnp.maximum(radiance, 0.0)


def render(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    progress_callback=None,
    preview_every: int = 0,
    preview_fn=None,
) -> jax.Array:
    """Full render -> mean radiance [H, W, 3] (pre-tonemap).

    ``settings.scheduler`` picks the engine: "regen" traces all samples in
    one regenerative-pool call (ops.wavefront); "scan" accumulates one
    progressive sample wave at a time like the reference's frame loop.

    ``preview_every``/``preview_fn``: progressive preview — the reference
    displays the accumulating image after every frame
    (program-raymarch.ts:277-318); here ``preview_fn(done_spp, mean_hw3)``
    is called with the running mean radiance every ``preview_every``
    samples (the regen pool is chunked via ``sample_offset`` to surface
    intermediates; counter-based RNG keeps the final image identical to an
    unchunked render up to summation order).
    """
    preview_every = preview_every if preview_fn is not None else 0
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    n_pixels = settings.width * settings.height
    spp = settings.samples_per_pixel

    if settings.scheduler == "regen":
        from pathtracer_tpu.ops.wavefront import (
            render_pool,
            render_regenerative,
        )

        if not preview_every:
            img = render_regenerative(scene, camera, settings)
            if progress_callback is not None:
                progress_callback(spp, spp)
            return img

        acc = jnp.zeros((n_pixels, 3), dtype=jnp.float32)
        done = 0
        while done < spp:
            n = min(preview_every, spp - done)
            img, _, _ = render_pool(
                scene,
                frame,
                settings,
                n_pixels=n_pixels,
                batch=min(settings.batch_size, n_pixels * n),
                rays_per_pixel=n,
                sample_offset=done,
            )
            acc = acc + img
            done += n
            if done < spp:
                preview_fn(
                    done,
                    (acc / done).reshape(settings.height, settings.width, 3),
                )
            if progress_callback is not None:
                progress_callback(done, spp)
        return (acc / spp).reshape(settings.height, settings.width, 3)

    acc = jnp.zeros((n_pixels, 3), dtype=jnp.float32)
    for s in range(spp):
        acc = acc + sample_wave(scene, frame, settings, jnp.uint32(s))
        done = s + 1
        if preview_every and done % preview_every == 0 and done < spp:
            preview_fn(
                done, (acc / done).reshape(settings.height, settings.width, 3)
            )
        if progress_callback is not None:
            progress_callback(done, spp)
    mean = acc / spp
    return mean.reshape(settings.height, settings.width, 3)


def render_checkpointed(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    checkpoint_path: str,
    chunk_samples: int = 8,
    progress_callback=None,
) -> jax.Array:
    """Resumable render: accumulates in chunks, persisting state after each.

    Counter-based RNG makes the resumed result identical to a
    straight-through render (utils.checkpoint). Kill it at any point and
    rerun with the same arguments to continue.
    """
    from pathtracer_tpu.ops.wavefront import render_pool
    from pathtracer_tpu.utils.checkpoint import (
        load_render_state,
        render_fingerprint,
        save_render_state,
    )

    fp = render_fingerprint(scene, settings)
    n_pixels = settings.width * settings.height
    state = load_render_state(checkpoint_path, fp)
    if state is not None:
        acc, done = jnp.asarray(state[0]), state[1]
    else:
        acc, done = jnp.zeros((n_pixels, 3), dtype=jnp.float32), 0

    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    spp = settings.samples_per_pixel
    while done < spp:
        n = min(chunk_samples, spp - done)
        img, _, _ = render_pool(
            scene,
            frame,
            settings,
            n_pixels=n_pixels,
            batch=min(settings.batch_size, n_pixels * n),
            rays_per_pixel=n,
            sample_offset=done,
        )
        acc = acc + img
        done += n
        save_render_state(checkpoint_path, jax.device_get(acc), done, fp)
        if progress_callback is not None:
            progress_callback(done, spp)
    return (acc / spp).reshape(settings.height, settings.width, 3)


def render_image(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    tonemap: str = "reference",
    progress_callback=None,
    preview_every: int = 0,
    preview_fn=None,
) -> np.ndarray:
    """Render + tonemap -> numpy [H, W, 3] float in [0, 1]."""
    mean = render(
        scene, camera, settings, progress_callback,
        preview_every=preview_every, preview_fn=preview_fn,
    )
    out = TONEMAPS[tonemap](mean)
    return np.asarray(jax.device_get(out))
