"""Test harness config: tests run on the CPU with 8 virtual devices.

Sharding logic is validated on the virtual devices. Tests marked ``gpu``
need a card: they skip here, and run on one with
``PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/ -m gpu``.
"""

import os

if not os.environ.get("PT_TPU_TEST_REAL_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import pathlib

import numpy as np
import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE.exists():
        pytest.skip("reference assets not available")
    return REFERENCE


@pytest.fixture(scope="session")
def cornell_ini(reference_root):
    return str(reference_root / "scene_files/final/cornell_box_full_lighting.ini")


@pytest.fixture(scope="session")
def cornell_scene(cornell_ini):
    """CornellBox at reduced size for fast CPU integration tests."""
    from pathtracer_tpu.models.scene import load_scene

    scene, camera, settings, ini = load_scene(
        cornell_ini, width=64, height=64, samples_per_pixel=8
    )
    return scene, camera, settings


@pytest.fixture()
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture()
def gpu_device():
    """The first GPU, or skip (decided here, never at import time)."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (PT_TPU_TEST_REAL_DEVICE=1 on a card)")
