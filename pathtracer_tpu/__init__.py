"""pathtracer_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
WebGPU/WGSL path tracer (Kauhentus/brown-cs2240-path-tracer):

- ``models``   — host-side scene frontend: INI configs, XML scene graphs,
  OBJ/MTL meshes, materials, SAH BVH build, SoA packing.
  (reference: src/index.ts, src/ts-util/*, src/packer.ts)
- ``ops``      — device compute: camera ray generation, ray/triangle/AABB/
  sphere intersection (brute sweep, block-shortlist, BVH oracle), BSDFs,
  next-event estimation, the wavefront integrator, tone mapping.
  (reference: src/program-raymarch.wgsl, src/wgsl-util/*.wgsl, src/primitive.wgsl)
- ``parallel`` — ``jax.sharding`` mesh construction, sharded rendering and
  gradient ``psum`` for multi-chip / multi-host execution.
  (reference has no distributed tier; this is new capability)
- ``utils``    — math helpers, image IO, profiling counters, checkpointing.

Unlike the reference's megakernel (one thread = one pixel, divergent
``while`` loop), the integrator here is a *wavefront*: a flat SoA batch of
rays advanced through a bounded ``lax.scan`` over bounces with masked lanes,
so every bounce is dense array work that XLA fuses.
"""

__version__ = "0.1.0"

# Lazy exports (PEP 562). Eager imports would pull in modules whose
# module-level jnp constants initialize the XLA backend at import time —
# which must not happen before jax.distributed.initialize() on multi-host
# runs (parallel.distributed).
_EXPORTS = {
    "load_scene": "pathtracer_tpu.models.scene",
    "Scene": "pathtracer_tpu.models.scene",
    "RenderSettings": "pathtracer_tpu.models.scene",
    "render": "pathtracer_tpu.render",
    "render_image": "pathtracer_tpu.render",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
