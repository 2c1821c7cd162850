"""Counter-based RNG for path tracing.

Replaces the reference's integer-hash chain (``src/wgsl-util/hash.wgsl``:
the classic ``n<<13 ^ n`` one-liner, re-hashed ad hoc through the kernel)
with *structural* counter-based generators: every draw is a pure function of
(pixel_id, sample_id, bounce, purpose). This makes renders independent of
batch chunking or device placement — a render sharded over N chips is
bit-identical to a single-chip render — and lets the backward path-replay
pass regenerate the exact forward samples.

Two interchangeable generators (``RenderSettings.rng``):

- ``hash`` (default): two rounds of the murmur3 finalizer over the mixed
  counters. Pure [B]-elementwise u32 ops — far cheaper than per-ray
  threefry and far stronger than the reference's single-round hash.
- ``threefry``: JAX's counter-based threefry keys (crypto-strength; the
  validation oracle for the hash generator).

Cost structure: a full two-round hash is several u32 multiplies per
element, and a bounce takes 7+ draws. Per-bounce draws therefore use
*one* full-strength base hash of (pixel, sample, bounce) and derive each
purpose slot with a single xorshift-multiply round over
``base ^ slot_salt`` — the base is already avalanched, so one nonlinear
round decorrelates slots (validated by the uniformity/correlation tests
and golden-image MSE).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Draw-purpose slots within one bounce (stride leaves room to grow).
STRIDE = 8
LIGHT_CHOICE = 0
LIGHT_BARY = 1  # consumes 2 uniforms
RR = 3
FRESNEL = 4
BSDF_DIR = 5  # consumes 2 uniforms
PIXEL_JITTER = 1 << 20  # reserved counter block for bounce-independent draws

_C1 = jnp.uint32(0x9E3779B1)  # golden-ratio Weyl constant
_C2 = jnp.uint32(0x85EBCA77)
_C3 = jnp.uint32(0xC2B2AE3D)
_M1 = jnp.uint32(0x85EBCA6B)  # murmur3 fmix32 constants
_M2 = jnp.uint32(0xC2B2AE35)


def _fmix32(x):
    """murmur3 finalizer: full avalanche over 32 bits."""
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 13)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def _seed_mix(seed: int) -> int:
    """Host-side fmix32 of a Python seed; 0 -> 0 (seedless = legacy stream)."""
    x = seed & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def hash_u32(pixel_ids, sample_ids, counter, seed: int = 0):
    """Well-mixed u32 from (pixel, sample, counter) — [B] u32 or scalars.

    ``counter`` may be a Python int, scalar, or per-lane [B] array (the
    regenerative wavefront tracks a per-lane bounce depth). ``seed`` is a
    static Python int selecting an independent stream; seed 0 reproduces
    the seedless stream (the goldens' stream).
    """
    counter = jnp.asarray(counter).astype(jnp.uint32)
    h = (pixel_ids.astype(jnp.uint32) * _C1) ^ jnp.uint32(_seed_mix(seed))
    h = _fmix32(h ^ (sample_ids.astype(jnp.uint32) * _C2))
    h = _fmix32(h ^ (counter * _C3))
    return h


def hash_uniform(pixel_ids, sample_ids, counter, seed: int = 0):
    """[B] uniforms in [0, 1) from the hash generator (24-bit mantissa)."""
    bits = hash_u32(pixel_ids, sample_ids, counter, seed)
    return _u01(bits)


def _u01(bits):
    """u32 bits -> f32 uniform in [0, 1) (top 24 bits)."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


_XM = jnp.uint32(0x7FEB352D)  # single-round mixer multiplier (degski/xmx)


def _xmx(x):
    """One-multiply finalizer (xorshift-multiply-xorshift).

    Used only to scramble an already-avalanched base hash into per-purpose
    slots; one u32 multiply instead of fmix32's two.
    """
    x = x ^ (x >> 16)
    x = x * _XM
    x = x ^ (x >> 15)
    return x


def _slot_salt(i: int) -> int:
    """Distinct well-spread u32 salt per draw-purpose slot (host-side)."""
    x = ((i + 1) * 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    return x


def bounce_uniforms_hash(pixel_ids, sample_ids, bounce, n: int = STRIDE,
                         seed: int = 0):
    """[B, n] uniforms for one bounce.

    One full-strength base hash of (pixel, sample, bounce), then one cheap
    nonlinear round per purpose slot (see module docstring for why).
    ``bounce`` may be a scalar or per-lane [B] array.
    """
    base = hash_u32(pixel_ids, sample_ids, bounce, seed)
    cols = [_u01(_xmx(base ^ jnp.uint32(_slot_salt(i)))) for i in range(n)]
    return jnp.stack(cols, axis=-1)


def pixel_jitter_hash(pixel_ids, sample_ids, seed: int = 0):
    """[B, 2] sub-pixel jitter in [0, 1)."""
    base = hash_u32(pixel_ids, sample_ids, PIXEL_JITTER, seed)
    return jnp.stack(
        [_u01(base), _u01(_xmx(base ^ jnp.uint32(_slot_salt(1))))],
        axis=-1,
    )


def pixel_jitter(settings, pixel_ids, sample_ids):
    """[B, 2] sub-pixel jitter via the configured generator + seed.

    Single entry point for every renderer (forward, sharded, inverse) so
    ``RenderSettings.seed`` is honored uniformly — previously each call site
    hardcoded ``PRNGKey(0)``.
    """
    if settings.rng == "threefry":
        keys = ray_keys(
            jax.random.PRNGKey(settings.seed), pixel_ids, sample_ids
        )
        return pixel_jitter_threefry(keys)
    return pixel_jitter_hash(pixel_ids, sample_ids, seed=settings.seed)


# --- threefry path (validation oracle / crypto-strength option) ---


def ray_keys(base_key: jax.Array, pixel_ids: jax.Array, sample_ids: jax.Array):
    """Per-ray threefry keys from global pixel ids [B] and sample ids [B]."""
    fold = jax.vmap(jax.random.fold_in, in_axes=(None, 0))
    keys = fold(base_key, pixel_ids.astype(jnp.uint32))
    return jax.vmap(jax.random.fold_in)(keys, sample_ids.astype(jnp.uint32))


def bounce_uniforms_threefry(keys: jax.Array, bounce, n: int = STRIDE) -> jax.Array:
    """[B, n] uniforms in [0, 1) for one bounce, one row per ray."""
    folded = jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, bounce)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(folded)


def pixel_jitter_threefry(keys: jax.Array) -> jax.Array:
    folded = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
        keys, jnp.uint32(PIXEL_JITTER)
    )
    return jax.vmap(lambda k: jax.random.uniform(k, (2,)))(folded)
