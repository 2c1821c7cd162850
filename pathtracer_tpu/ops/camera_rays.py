"""Primary-ray generation (device side).

Equivalent of the reference's per-pixel camera setup
(``src/program-raymarch.wgsl:50-74``): sub-pixel jittered pinhole rays with
vertical FOV and focal length 1. Operates on flat ray batches (a chunk of
pixel ids x one sample index each), producing SoA origin/direction arrays.
"""

from __future__ import annotations

import jax.numpy as jnp


def generate_rays(frame: dict, width: int, height: int, pixel_ids, jitter):
    """Rays for flat pixel ids [B] with per-ray jitter [B, 2] in [0, 1).

    ``frame`` comes from ``models.camera.Camera.ray_frame``. The pixel
    mapping matches the reference (y flipped so row 0 is the image top,
    jitter centered at the pixel center):

        nx = (px + jitter - 0.5 + 0.5) / W - 0.5
        ny = (H - 1 - (py + jitter - 0.5) + 0.5) / H - 0.5
        dir = normalize(nx * span_x * right + ny * span_y * up + look)
    """
    px = (pixel_ids % width).astype(jnp.float32) + jitter[:, 0] - 0.5
    py = (pixel_ids // width).astype(jnp.float32) + jitter[:, 1] - 0.5

    nx = (px + 0.5) / width - 0.5
    ny = (height - 1.0 - py + 0.5) / height - 0.5

    span = frame["span"]
    d = (
        (nx * span[0])[:, None] * frame["right"][None, :]
        + (ny * span[1])[:, None] * frame["up"][None, :]
        + frame["look"][None, :]
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    # Data-dependence on d (not broadcast_to) so o carries the same
    # shard_map varying-axis annotation as the rest of the ray state.
    o = frame["origin"][None, :] + d * 0.0
    return o, d
