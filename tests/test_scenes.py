"""End-to-end coverage of every shipped reference scene.

The milestone configs, CornellBox2 (the two-primitive scene
that the reference's ``.slice(0, 1)`` bug silently truncates,
src/index.ts:116), ColoredBox, and an analytic-primitive XML scene must all
be exercised by render tests, not just parse tests. Pairing contract:
/root/reference/submission-milestone.md:22-25.
"""

import numpy as np
import pytest

from pathtracer_tpu.models.scene import load_scene, scene_from_graph
from pathtracer_tpu.models.scenegraph import load_scenegraph, parse_scenegraph
from pathtracer_tpu.ops.tonemap import tonemap_reference
from pathtracer_tpu.render import render
from pathtracer_tpu.utils.image import mse


def test_cornellbox2_merges_both_meshes(reference_root):
    """CornellBox2 = CornellBox-Original + MedievalBoat. The reference loads
    only the first (index.ts:116); we must merge both and render them."""
    ini = str(reference_root / "scene_files/milestone/cornell_box_milestone.ini")
    scene, camera, settings, parsed = load_scene(
        ini, width=32, height=32, samples_per_pixel=2
    )
    # 36 (CornellBox quad-split) + 12571+ (boat) triangles, all live.
    assert scene.num_tris > 12571, "second primitive was dropped"
    img = np.asarray(render(scene, camera, settings))
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


def test_sphere_milestone_matches_reference_render(reference_root):
    """sphere_milestone.ini (CornellBox-Sphere) vs the reference's own
    student output, MSE at 48px/8spp (same harness as tests/test_golden)."""
    from PIL import Image

    size, spp = 48, 8
    ini = str(reference_root / "scene_files/milestone/sphere_milestone.ini")
    scene, camera, settings, _ = load_scene(
        ini, width=size, height=size, samples_per_pixel=spp
    )
    img = np.asarray(tonemap_reference(render(scene, camera, settings)))
    golden_path = reference_root / "student_outputs/milestone/sphere_milestone.png"
    golden = (
        np.asarray(
            Image.open(golden_path).convert("RGB").resize((size, size)),
            dtype=np.float32,
        )
        / 255.0
    )
    err = mse(img, golden)
    # Noise floor at 48px/8spp measured ~0.011; threshold 2x.
    assert err < 0.025, f"sphere_milestone: MSE {err:.5f}"


def test_coloredbox_renders(reference_root):
    """ColoredBox.xml: ColoredCube mesh with an emissive face (Ke 17 12 4
    in ColoredCube.mtl) -> finite, lit render."""
    graph = load_scenegraph(str(reference_root / "scene_assets/ColoredBox.xml"))
    scene, camera = scene_from_graph(
        graph, str(reference_root / "scene_assets")
    )
    from pathtracer_tpu.models.scene import RenderSettings

    settings = RenderSettings(width=24, height=24, samples_per_pixel=2)
    assert int(scene.num_emissive) > 0
    img = np.asarray(render(scene, camera, settings))
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


ANALYTIC_XML = """
<scenefile>
  <cameradata>
    <pos x="0" y="1" z="4"/>
    <up x="0" y="1" z="0"/>
    <focus x="0" y="1" z="0"/>
    <heightangle v="45"/>
  </cameradata>
  <object type="tree" name="root">
    <transblock>
      <translate x="0" y="0" z="0"/>
      <object type="primitive" name="mesh"
              filename="models/CornellBox/CornellBox-Original.obj"/>
    </transblock>
    <transblock>
      <translate x="-0.45" y="0.8" z="0"/>
      <scale x="0.8" y="0.8" z="0.8"/>
      <object type="primitive" name="sphere">
        <diffuse r="0.2" g="0.4" b="0.8"/>
      </object>
    </transblock>
    <transblock>
      <translate x="0.5" y="0.3" z="0.3"/>
      <scale x="0.6" y="0.6" z="0.6"/>
      <rotate x="0" y="1" z="0" angle="25"/>
      <object type="primitive" name="cube">
        <diffuse r="0.8" g="0.6" b="0.2"/>
      </object>
    </transblock>
  </object>
</scenefile>
"""


def test_analytic_xml_scene_renders(reference_root):
    """XML-driven mixed scene: triangle mesh + analytic sphere + cube
    (BASELINE config 3; resurrects the reference's dead primitive.wgsl)."""
    graph = parse_scenegraph(ANALYTIC_XML)
    assert [p.kind for p in graph.primitives] == ["mesh", "sphere", "cube"]
    scene, camera = scene_from_graph(
        graph, str(reference_root / "scene_assets")
    )
    assert scene.num_analytic == 2
    assert scene.num_tris > 0

    from pathtracer_tpu.models.scene import RenderSettings

    settings = RenderSettings(width=32, height=32, samples_per_pixel=4)
    img = np.asarray(render(scene, camera, settings))
    assert np.isfinite(img).all()
    assert img.mean() > 0.0

    # The analytic primitives must actually be visible: a mesh-only scene
    # from the same graph renders a different image.
    graph_mesh_only = parse_scenegraph(ANALYTIC_XML)
    graph_mesh_only.primitives = [
        p for p in graph_mesh_only.primitives if p.kind == "mesh"
    ]
    scene2, camera2 = scene_from_graph(
        graph_mesh_only, str(reference_root / "scene_assets")
    )
    img2 = np.asarray(render(scene2, camera2, settings))
    assert mse(img, img2) > 1e-4, "analytic primitives not visible"
