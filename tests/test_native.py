"""Native (C++) component parity: builders/parsers must match their Python
fallbacks exactly (the fallbacks are the spec)."""

import os

import numpy as np
import pytest

from pathtracer_tpu import native
from pathtracer_tpu.native import get_lib


@pytest.fixture()
def native_lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    return lib


class TestBuildKey:
    def test_library_lives_under_its_key(self):
        key = native.build_key()
        assert native.build_key() == key  # stable
        path = native.lib_path()
        assert path == os.path.join(native._BUILD_ROOT, key, "libptnative.so")

    def test_key_follows_sources_and_host(self, monkeypatch, tmp_path):
        key = native.build_key()
        for name in native._SOURCES:
            (tmp_path / name).write_bytes(
                open(os.path.join(native._DIR, name), "rb").read()
            )
        monkeypatch.setattr(native, "_DIR", str(tmp_path))
        assert native.build_key() == key
        with open(tmp_path / native._SOURCES[0], "a") as f:
            f.write("\n// edited\n")
        edited = native.build_key()
        assert edited != key
        monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
        assert native.build_key() not in (key, edited)

    def test_loads_only_its_own_build(self, monkeypatch, tmp_path):
        """A library left next to the sources (the old location) or under
        another key is ignored; get_lib builds and loads its own."""
        for name in native._SOURCES:
            (tmp_path / name).write_bytes(
                open(os.path.join(native._DIR, name), "rb").read()
            )
        (tmp_path / "_libptnative.so").write_bytes(b"not a library")
        stray = tmp_path / "_build" / "0123456789abcdef"
        stray.mkdir(parents=True)
        (stray / "libptnative.so").write_bytes(b"not a library")
        monkeypatch.setattr(native, "_DIR", str(tmp_path))
        monkeypatch.setattr(native, "_BUILD_ROOT", str(tmp_path / "_build"))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.delenv("PT_TPU_NO_NATIVE", raising=False)
        lib = native.get_lib()
        if lib is None:
            pytest.skip("no C++ toolchain")
        assert lib._name == native.lib_path()
        assert native.lib_path().startswith(str(tmp_path / "_build"))


@pytest.mark.usefixtures("native_lib")
class TestNativeBvh:
    def test_matches_python_invariants(self, rng_np):
        from pathtracer_tpu.models.bvh import build_bvh_native, bvh_depth

        n = 3000
        v0 = rng_np.uniform(-10, 10, (n, 3))
        lo = v0 - rng_np.uniform(0, 1, (n, 3))
        hi = v0 + rng_np.uniform(0, 1, (n, 3))
        bvh = build_bvh_native(lo, hi, 8)
        assert bvh is not None
        assert sorted(bvh.prim_order.tolist()) == list(range(n))
        # Leaf ranges partition [0, n).
        covered = np.zeros(n, dtype=int)
        for node in range(bvh.num_nodes):
            for s in range(2):
                if bvh.child[node, s] < 0:
                    a, c = bvh.leaf_start[node, s], bvh.leaf_count[node, s]
                    covered[a : a + c] += 1
        assert (covered == 1).all()
        assert bvh_depth(bvh) < 32
        assert bvh.leaf_count.max() <= 8

    def test_traversal_equivalence(self, rng_np):
        """Native-built trees must intersect identically to brute force."""
        import jax.numpy as jnp

        from pathtracer_tpu.models.obj import ObjMaterial, ObjMesh
        from pathtracer_tpu.models.pack import pack_scene
        from pathtracer_tpu.models.scene import _to_device
        from pathtracer_tpu.ops.bvh_traverse import closest_tri_bvh
        from pathtracer_tpu.ops.intersect import closest_tri_brute

        n = 800
        v0 = rng_np.uniform(-5, 5, (n, 3))
        v1 = v0 + rng_np.uniform(-1, 1, (n, 3))
        v2 = v0 + rng_np.uniform(-1, 1, (n, 3))
        mesh = ObjMesh(
            positions=np.concatenate([v0, v1, v2]),
            normals=np.zeros((0, 3)),
            faces=np.arange(3 * n, dtype=np.int32).reshape(3, n).T,
            face_normals=np.full((n, 3), -1, dtype=np.int32),
            face_material=np.zeros(n, dtype=np.int32),
            materials=[ObjMaterial()],
        )
        scene = _to_device(pack_scene(mesh, max_leaf=6))
        o = jnp.asarray(rng_np.uniform(-6, 6, (256, 3)))
        d = jnp.asarray(rng_np.normal(size=(256, 3)))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        t_ref, _ = closest_tri_brute(scene, o, d)
        t_bvh, _ = closest_tri_bvh(scene, o, d)
        hit = np.isfinite(np.asarray(t_ref))
        np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_bvh)))
        np.testing.assert_allclose(
            np.asarray(t_bvh)[hit], np.asarray(t_ref)[hit], rtol=1e-5, atol=1e-6
        )

    def test_single_leaf(self):
        from pathtracer_tpu.models.bvh import build_bvh_native

        lo = np.zeros((3, 3))
        hi = np.ones((3, 3))
        bvh = build_bvh_native(lo, hi, 8)
        assert bvh.num_nodes == 1
        assert bvh.leaf_count[0, 0] == 3
        assert bvh.leaf_count[0, 1] == 0


@pytest.mark.usefixtures("native_lib")
class TestNativeObj:
    def test_matches_python_on_reference_meshes(self, reference_root):
        from pathtracer_tpu.models.obj import parse_obj

        for rel in (
            "scene_assets/models/CornellBox/CornellBox-Original.obj",
            "scene_assets/models/CornellBox/CornellBox-Sphere.obj",
            "scene_assets/models/Cube.obj",
        ):
            text = (reference_root / rel).read_text()
            a = parse_obj(text)
            b = parse_obj(text, use_native=False)
            np.testing.assert_allclose(a.positions, b.positions)
            np.testing.assert_array_equal(a.faces, b.faces)
            np.testing.assert_array_equal(a.face_normals, b.face_normals)
            np.testing.assert_array_equal(a.face_material, b.face_material)
            assert [m.name for m in a.materials] == [m.name for m in b.materials]

    def test_negative_indices_and_ngons(self):
        from pathtracer_tpu.models.obj import parse_obj

        text = (
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
            "f -5 -4 -3 -2 -1\n"  # 5-gon fan split, negative indices
        )
        a = parse_obj(text)
        b = parse_obj(text, use_native=False)
        np.testing.assert_array_equal(a.faces, b.faces)
        assert a.faces.shape == (3, 3)
