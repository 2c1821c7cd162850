"""Sharded rendering over a device mesh.

The path-tracing analogue of data parallelism (SURVEY.md §2.4): the flat
pixel batch shards across the ``rays`` mesh axis, the scene replicates, and
each device traces its pixel slice with ``shard_map``. Because the RNG is
counter-based on (pixel, sample) — ops.rng — the sharded render is
bit-identical to the single-device render regardless of device count or
placement.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from pathtracer_tpu.models.camera import Camera
from pathtracer_tpu.models.scene import RenderSettings, Scene
from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.camera_rays import generate_rays
from pathtracer_tpu.ops.integrator import radiance_batch
from pathtracer_tpu.parallel.mesh import RAY_AXIS, make_mesh


def _wave_local(scene, frame, sample_idx, pixel_ids, settings):
    """Per-shard sample wave on local pixel ids [b_local]."""
    sample_ids = jnp.full(pixel_ids.shape, sample_idx, dtype=jnp.uint32)
    jitter = rng.pixel_jitter(settings, pixel_ids, sample_ids)
    o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
    return jnp.maximum(
        radiance_batch(scene, settings, o, d, pixel_ids, sample_ids), 0.0
    )


@functools.partial(jax.jit, static_argnames=("settings", "mesh"))
def sample_wave_sharded(scene: Scene, frame, settings: RenderSettings, sample_idx, mesh):
    """One sample for every pixel, pixels sharded over the mesh -> [HW, 3].

    Non-divisible pixel counts are padded with clamped duplicate ids (the
    duplicate rows trace redundantly and are sliced off) — counter-based RNG
    keeps the kept rows bit-identical to the single-device render.
    """
    n_pixels = settings.width * settings.height
    n_padded = -(-n_pixels // mesh.size) * mesh.size
    pixel_ids = jnp.minimum(
        jnp.arange(n_padded, dtype=jnp.uint32), jnp.uint32(n_pixels - 1)
    )

    wave = jax.shard_map(
        functools.partial(_wave_local, settings=settings),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
    )
    return wave(scene, frame, sample_idx, pixel_ids)[:n_pixels]


@functools.partial(jax.jit, static_argnames=("settings", "mesh"))
def _pool_sharded(scene: Scene, frame, settings: RenderSettings, mesh):
    """Regenerative pool over the mesh -> (image sum [HW, 3], rays, iters)."""
    from pathtracer_tpu.ops.wavefront import pool_ids_total, resolve_spawn_chunk

    n_pixels = settings.width * settings.height
    # Slice the pool's padded pixel-major id space in K-aligned chunks so
    # no spawn chunk spans a device boundary (ops.wavefront.render_pool).
    k = resolve_spawn_chunk(settings, n_pixels, settings.samples_per_pixel)
    total = pool_ids_total(settings, n_pixels, settings.samples_per_pixel)
    per_dev = -(-total // mesh.size)  # ceil; ragged tail masked by id_limit
    per_dev = -(-per_dev // k) * k

    def local(scene, frame):
        from pathtracer_tpu.ops.wavefront import render_pool

        rank = jax.lax.axis_index(RAY_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(per_dev)
        limit = jnp.minimum(jnp.uint32(total) - jnp.minimum(offset, total), per_dev)
        img, n_rays, iters = render_pool(
            scene,
            frame,
            settings,
            n_pixels=n_pixels,
            batch=min(settings.batch_size, per_dev),
            rays_per_pixel=settings.samples_per_pixel,
            id_offset=offset,
            id_limit=limit,
            n_ids=per_dev,
        )
        return (
            jax.lax.psum(img, RAY_AXIS),
            jax.lax.psum(n_rays, RAY_AXIS),
            jax.lax.pmax(iters, RAY_AXIS),
        )

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P(), P())
    )(scene, frame)


def render_pool_sharded(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    mesh=None,
):
    """Regenerative-wavefront render sharded over the device mesh
    -> mean radiance [H, W, 3].

    Each device runs its own regeneration pool over a disjoint slice of the
    global pixel-major ray-id space; partial images ``psum`` over the mesh.
    Counter-based RNG makes every *path's* radiance bit-identical to the
    single-device pool; only the float summation order per pixel differs
    (tested to ~1e-6 relative). This is the multi-chip version of the
    fast path — the scan-based ``render_sharded`` stays as the
    bit-identical/differentiable variant.
    """
    mean, _, _ = render_pool_sharded_stats(scene, camera, settings, mesh)
    return mean


def render_pool_sharded_stats(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    mesh=None,
):
    """Sharded regenerative render -> (mean radiance [H, W, 3], total rays
    traced across devices, max pool iterations on any device).

    The ray counter is the same live-lane metric the single-device pool
    reports (SURVEY.md §5: rays/sec/chip as a first-class counter), psum'd
    over the mesh — the measuring stick for multi-chip scaling efficiency.
    """
    mesh = mesh if mesh is not None else make_mesh()
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    rep = NamedSharding(mesh, P())
    scene = jax.device_put(scene, rep)
    frame = jax.device_put(frame, rep)
    image, n_rays, iters = _pool_sharded(scene, frame, settings, mesh)
    mean = image / settings.samples_per_pixel
    return mean.reshape(settings.height, settings.width, 3), n_rays, iters


def render_sharded(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    mesh=None,
    progress_callback=None,
):
    """Progressive sharded render -> mean radiance [H, W, 3] (pre-tonemap)."""
    mesh = mesh if mesh is not None else make_mesh()
    n_pixels = settings.width * settings.height
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    # Replicate scene/frame; let pixels shard.
    rep = NamedSharding(mesh, P())
    scene = jax.device_put(scene, rep)
    frame = jax.device_put(frame, rep)

    acc = jnp.zeros((n_pixels, 3), dtype=jnp.float32)
    for s in range(settings.samples_per_pixel):
        acc = acc + sample_wave_sharded(scene, frame, settings, jnp.uint32(s), mesh)
        if progress_callback is not None:
            progress_callback(s + 1, settings.samples_per_pixel)
    mean = acc / settings.samples_per_pixel
    return mean.reshape(settings.height, settings.width, 3)
