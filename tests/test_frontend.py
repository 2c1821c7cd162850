"""Unit tests for the scene frontend (INI / XML / OBJ / MTL / camera).

Fixtures are the reference's shipped assets (SURVEY.md §4: parser fixtures
against Cube.obj / CornellBox-Original etc.).
"""

import numpy as np
import pytest

from pathtracer_tpu.models.camera import Camera
from pathtracer_tpu.models.ini import ini_to_scene, load_ini, parse_ini
from pathtracer_tpu.models.obj import load_obj, parse_mtl, parse_obj
from pathtracer_tpu.models.scenegraph import load_scenegraph, parse_scenegraph
from pathtracer_tpu.utils.math import mat4_rot_axis, mat4_translate


class TestIni:
    def test_parse_sections(self):
        text = """
[IO]
    scene = /scene_assets/CornellBox.xml
    output = out.png

[Settings]
    imageWidth = 512
    samplesPerPixel = 50
"""
        sections = parse_ini(text)
        assert sections["IO"]["scene"] == "/scene_assets/CornellBox.xml"
        assert sections["Settings"]["imageWidth"] == "512"

    def test_typed_conversion(self):
        sections = {
            "IO": {"scene": "s.xml", "output": "o.png"},
            "Settings": {
                "imageWidth": "512",
                "imageHeight": "256",
                "samplesPerPixel": "50",
                "pathContinuationProb": "0.9",
                "directLightingOnly": "true",
                "numDirectLightingSamples": "4",
            },
        }
        ini = ini_to_scene(sections)
        assert ini.image_width == 512
        assert ini.image_height == 256
        assert ini.direct_lighting_only is True
        assert ini.num_direct_lighting_samples == 4

    def test_missing_field_raises(self):
        with pytest.raises(ValueError):
            ini_to_scene({"IO": {}, "Settings": {}})

    def test_reference_configs(self, reference_root):
        for ini_path in (reference_root / "scene_files/final").glob("*.ini"):
            ini = load_ini(str(ini_path))
            assert ini.image_width == 512
            assert ini.samples_per_pixel in (50, 100, 200, 300)
            assert 0.0 < ini.path_continuation_prob <= 0.9


class TestObj:
    def test_triangle_and_quad(self):
        obj = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3
f 1 2 3 4
"""
        mesh = parse_obj(obj)
        # 1 triangle + quad split into 2 (parse-obj.ts:59-62 behavior).
        assert mesh.faces.shape == (3, 3)
        np.testing.assert_array_equal(mesh.faces[1], [0, 1, 2])
        np.testing.assert_array_equal(mesh.faces[2], [0, 2, 3])

    def test_negative_indices(self):
        obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
        mesh = parse_obj(obj)
        np.testing.assert_array_equal(mesh.faces[0], [0, 1, 2])

    def test_vertex_normal_indices_kept(self):
        obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n"
        mesh = parse_obj(obj)
        np.testing.assert_array_equal(mesh.face_normals[0], [0, 0, 0])

    def test_ctm_applies_translation_to_points(self):
        # The reference drops translations (inverse-transpose misuse,
        # parse-obj.ts:24); we must not.
        obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
        mesh = parse_obj(obj, ctm=mat4_translate(0.0, 0.1, 0.0))
        np.testing.assert_allclose(mesh.positions[0], [0.0, 0.1, 0.0])

    def test_normals_use_inverse_transpose(self):
        obj = "v 0 0 0\nvn 0 0 1\n"
        import pathtracer_tpu.utils.math as m

        ctm = m.mat4_scale(2.0, 1.0, 1.0) @ mat4_rot_axis(
            np.array([0, 1, 0]), np.pi / 2
        )
        mesh = parse_obj(obj, ctm=ctm)
        # Rotating z-normal about y by 90deg -> +x; scaling x by 2 scales the
        # normal by 1/2 then renormalizes -> still unit +x.
        np.testing.assert_allclose(mesh.normals[0], [1.0, 0.0, 0.0], atol=1e-12)

    def test_mtl_parse(self):
        mtl = """
newmtl light
  Ns 10.0
  illum 2
  Kd 0.78 0.78 0.78
  Ke 17 12 4
"""
        mats = parse_mtl(mtl)
        assert mats["light"].Ke == (17.0, 12.0, 4.0)
        assert mats["light"].Ns == 10.0

    def test_cornell_box_original(self, reference_root):
        mesh = load_obj(
            str(
                reference_root
                / "scene_assets/models/CornellBox/CornellBox-Original.obj"
            )
        )
        # 72 verts / 18 quads -> 36 triangles after quad split.
        assert mesh.positions.shape == (72, 3)
        assert mesh.faces.shape == (36, 3)
        names = [m.name for m in mesh.materials]
        assert "light" in names
        light = mesh.materials[names.index("light")]
        assert light.Ke == (17.0, 12.0, 4.0)

    def test_medieval_boat(self, reference_root):
        mesh = load_obj(
            str(reference_root / "scene_assets/models/MedievalBoat/MedievalBoat.obj")
        )
        assert mesh.positions.shape[0] == 15222  # all `v` lines incl. tab-sep
        assert mesh.faces.shape[0] >= 12571  # quads split may add more


class TestSceneGraph:
    def test_cornell_graph(self, reference_root):
        g = load_scenegraph(str(reference_root / "scene_assets/CornellBox.xml"))
        assert g.camera.pos == (0.0, 1.0, 3.6)
        assert g.camera.height_angle_deg == 45.0
        assert len(g.primitives) == 1
        prim = g.primitives[0]
        assert prim.kind == "mesh"
        assert prim.filename.endswith("CornellBox-Original.obj")
        # translate(0, 0.1, 0) must survive into the CTM.
        np.testing.assert_allclose(prim.ctm[:3, 3], [0.0, 0.1, 0.0])

    def test_multiple_primitives_collected(self, reference_root):
        # CornellBox2.xml has two trees (box + boat); the reference keeps
        # only the first (index.ts:116) — we must keep both.
        g = load_scenegraph(str(reference_root / "scene_assets/CornellBox2.xml"))
        assert len(g.primitives) == 2

    def test_analytic_primitive(self):
        xml = """
<scenefile>
  <cameradata>
    <pos x="0" y="0" z="5"/><up x="0" y="1" z="0"/>
    <focus x="0" y="0" z="0"/><heightangle v="45"/>
  </cameradata>
  <object type="tree" name="root">
    <transblock>
      <translate x="1" y="0" z="0"/>
      <object type="primitive" name="sphere">
        <diffuse r="1" g="0" b="0"/>
      </object>
    </transblock>
  </object>
</scenefile>
"""
        g = parse_scenegraph(xml)
        assert g.primitives[0].kind == "sphere"
        np.testing.assert_allclose(g.primitives[0].ctm[:3, 3], [1, 0, 0])

    def test_unknown_type_raises(self):
        xml = """
<scenefile>
  <cameradata>
    <pos x="0" y="0" z="5"/><up x="0" y="1" z="0"/>
    <focus x="0" y="0" z="0"/><heightangle v="45"/>
  </cameradata>
  <object type="wobble" name="bad"/>
</scenefile>
"""
        with pytest.raises(ValueError):
            parse_scenegraph(xml)


class TestCamera:
    def test_basis_orthonormal(self):
        cam = Camera(pos=(0, 1, 3.6), up=(0, 1, 0), focus=(0, 1, 0), height_angle_deg=45)
        r, u, l = cam.basis()
        for v in (r, u, l):
            np.testing.assert_allclose(np.linalg.norm(v), 1.0, atol=1e-12)
        np.testing.assert_allclose(np.dot(r, u), 0, atol=1e-12)
        np.testing.assert_allclose(np.cross(r, l), u, atol=1e-12)

    def test_look_direction(self):
        cam = Camera(pos=(0, 1, 3.6), up=(0, 1, 0), focus=(0, 1, 0), height_angle_deg=45)
        _, _, look = cam.basis()
        np.testing.assert_allclose(look, [0, 0, -1], atol=1e-12)

    def test_cam_to_world_roundtrip(self):
        cam = Camera(pos=(3, 3, -3), up=(0, 1, 0), focus=(0, 2, 0), height_angle_deg=80)
        m = cam.cam_to_world() @ cam.world_to_cam()
        np.testing.assert_allclose(m, np.eye(4), atol=1e-12)


def test_png_roundtrip_without_pil_writer(tmp_path, rng_np):
    """write_png (zlib only) produces a PNG that a standard decoder reads
    back exactly."""
    from pathtracer_tpu.utils.image import read_png, write_png

    img = rng_np.integers(0, 256, (7, 5, 3)).astype(np.uint8)
    path = str(tmp_path / "rt.png")
    write_png(path, img)
    np.testing.assert_array_equal(
        np.round(read_png(path) * 255.0).astype(np.uint8), img
    )
