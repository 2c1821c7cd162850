"""Scene assembly: INI/XML/OBJ on disk -> device-resident ``Scene`` pytree.

Equivalent of the reference driver pipeline
(``src/index.ts:24-181``): INI -> XML scene graph -> OBJ/MTL meshes -> BVH ->
packed buffers. Two deliberate upgrades over the reference:

- **all** primitives in the scene graph are loaded (the reference silently
  keeps only the first, ``index.ts:116`` ``.slice(0, 1)``);
- the result is a typed JAX pytree (arrays ready for ``jit``/``pjit``), not a
  pair of raw float blobs.

``Scene`` is the single device-side input of every kernel; its array fields
are differentiable leaves (notably the material table) so inverse rendering
gets gradients "for free" through the pytree.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pathtracer_tpu.models.camera import Camera
from pathtracer_tpu.models.ini import IniScene, load_ini
from pathtracer_tpu.models.obj import ObjMaterial, load_obj
from pathtracer_tpu.models.pack import PackedScene, merge_meshes, pack_scene
from pathtracer_tpu.models.scenegraph import SceneGraph, load_scenegraph
from pathtracer_tpu.utils.pytree import pytree_node, static_field


@pytree_node
class Scene:
    """Device-side packed scene. Array leaves; static counts as aux data."""

    # Triangles (BVH leaf order, padded; see models.pack).
    tri_v0: object  # [T, 3] f32
    tri_e1: object
    tri_e2: object
    tri_n: object
    tri_vn: object  # [T, 3, 3] f32
    tri_mat: object  # [T] i32
    tri_valid: object  # [T] bool
    # Material SoA (differentiable).
    mat_Ns: object  # [M] f32
    mat_Ni: object
    mat_illum: object
    mat_Ka: object  # [M, 3] f32
    mat_Kd: object
    mat_Ks: object
    mat_Ke: object
    # Emissive table.
    emissive_tri: object  # [E] i32
    emissive_area: object  # [E] f32
    num_emissive: object  # [] i32 (traced: lights can be added dynamically)
    # BVH (SoA flattened; see models.bvh.FlatBVH).
    bvh_child: object  # [N, 2] i32
    bvh_leaf_start: object
    bvh_leaf_count: object
    bvh_lo: object  # [N, 2, 3] f32
    bvh_hi: object
    # Analytic primitives.
    prim_kind: object  # [S] i32
    prim_ctm: object  # [S, 4, 4] f32
    prim_ctm_inv: object
    prim_mat: object  # [S] i32
    # Static metadata (not traced).
    num_tris: int = static_field(default=0)
    num_analytic: int = static_field(default=0)
    bvh_depth: int = static_field(default=1)
    max_leaf_size: int = static_field(default=8)

    @property
    def padded_tris(self) -> int:
        return int(self.tri_v0.shape[0])


# Intersector names ``RenderSettings.intersector`` accepts.
INTERSECTORS = ("auto", "brute", "sweep", "shortlist", "bvh")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static (hashable) render configuration; a jit static argument.

    Mirrors the INI ``Settings`` block plus integrator knobs. ``compat_*``
    flags reproduce reference estimator quirks needed to match its golden
    images; turning them off yields the physically-corrected estimator
    (see SURVEY.md §7 "deliberate deviations").
    """

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 16
    max_depth: int = 17  # reference: while(depth <= 16), program-raymarch.wgsl:118
    rr_prob: float = 0.9
    direct_lighting_only: bool = False
    num_direct_lighting_samples: int = 1
    # Compat quirks (defaults reproduce the reference's golden images):
    # count-based light pdf with no area correction (intersection-logic.wgsl:284)
    compat_count_light_pdf: bool = True
    # `hit_specular` is sticky for the whole path (program-raymarch.wgsl:*)
    compat_sticky_specular: bool = True
    # dielectric eta hardcoded to 2.5 (program-raymarch.wgsl:206)
    compat_fixed_eta: bool = True
    # shading normal = geometric normal (vertex normals abandoned in reference)
    use_vertex_normals: bool = False
    # Implementation selection (INTERSECTORS): "auto" (see
    # ops.intersect.resolve_intersector) | "brute" (XLA sweep) | "sweep"
    # (Triton kernel, scenes of <= TMAJOR_MAX_T tris) | "shortlist" |
    # "bvh" (the traversal oracle).
    intersector: str = "auto"
    # NEE shadow rays: "fast" (t-only occlusion sweep; light attributes from
    # the sample itself) | "closest" (full closest-hit, the reference's
    # exact shadow semantics — oracle for "fast")
    shadow_mode: str = "fast"
    # Glossy-lane BRDF: "phong" (the reference's live lobe) | "beckmann"
    # (corrected version of its disabled branch, program-raymarch.wgsl:281)
    glossy_brdf: str = "phong"
    # Beckmann roughness; 0 derives alpha = sqrt(2 / (Ns + 2)) per material
    beckmann_alpha: float = 0.0
    # RNG: "hash" (fast murmur3-finalizer counters) | "threefry" (oracle)
    rng: str = "hash"
    # RNG stream seed (0 = the goldens' stream). Honored by both generators.
    seed: int = 0
    # Scheduler: "regen" (regenerative wavefront pool, ~4x faster) |
    # "scan" (fixed-depth wave per sample; the differentiable path)
    scheduler: str = "regen"
    # Pool lane sorting by (spatial cell, direction octant) each iteration:
    # "auto" (on when the resolved intersector is block-granular — the
    # shortlist family; off for brute) | "on" | "off". Lane order never
    # changes per-path radiance (counter RNG); only fp accumulation order.
    ray_sort: str = "auto"
    # Samples per lane spawn in the regenerative pool: a lane draws a
    # (pixel, K-sample) chunk, accumulates the K paths in-lane, and
    # flushes ONE image row per chunk — cutting the row-count-bound flush
    # scatter ~Kx. 0 = auto (K=4 when the workload leaves >= 16 chunks of
    # work-stealing slack per lane, else 1 — measured +23% at spp1024,
    # -17% at spp16; ops.wavefront.resolve_spawn_chunk). The global
    # counter still balances work across chunks. Per-path radiance is
    # unchanged (counter RNG); only fp accumulation order differs.
    spawn_chunk: int = 0
    # Rays per device batch (pixels*samples are chunked to this).
    batch_size: int = 1 << 18

    def __post_init__(self):
        if self.intersector not in INTERSECTORS:
            raise ValueError(
                f"unknown intersector {self.intersector!r}; "
                f"available: {', '.join(INTERSECTORS)}"
            )

    @classmethod
    def from_ini(cls, ini: IniScene, **overrides) -> "RenderSettings":
        kw = dict(
            width=ini.image_width,
            height=ini.image_height,
            samples_per_pixel=ini.samples_per_pixel,
            rr_prob=ini.path_continuation_prob,
            direct_lighting_only=ini.direct_lighting_only,
            num_direct_lighting_samples=max(1, ini.num_direct_lighting_samples),
        )
        kw.update(overrides)
        return cls(**kw)


def _to_device(packed: PackedScene) -> Scene:
    import jax.numpy as jnp

    from pathtracer_tpu.models.bvh import bvh_depth

    m = packed.materials
    return Scene(
        tri_v0=jnp.asarray(packed.tri_v0),
        tri_e1=jnp.asarray(packed.tri_e1),
        tri_e2=jnp.asarray(packed.tri_e2),
        tri_n=jnp.asarray(packed.tri_n),
        tri_vn=jnp.asarray(packed.tri_vn),
        tri_mat=jnp.asarray(packed.tri_mat),
        tri_valid=jnp.asarray(packed.tri_valid),
        mat_Ns=jnp.asarray(m.Ns),
        mat_Ni=jnp.asarray(m.Ni),
        mat_illum=jnp.asarray(m.illum),
        mat_Ka=jnp.asarray(m.Ka),
        mat_Kd=jnp.asarray(m.Kd),
        mat_Ks=jnp.asarray(m.Ks),
        mat_Ke=jnp.asarray(m.Ke),
        emissive_tri=jnp.asarray(packed.emissive_tri),
        emissive_area=jnp.asarray(packed.emissive_area),
        num_emissive=jnp.asarray(packed.num_emissive, dtype=jnp.int32),
        bvh_child=jnp.asarray(packed.bvh.child),
        bvh_leaf_start=jnp.asarray(packed.bvh.leaf_start),
        bvh_leaf_count=jnp.asarray(packed.bvh.leaf_count),
        bvh_lo=jnp.asarray(packed.bvh.bounds_lo),
        bvh_hi=jnp.asarray(packed.bvh.bounds_hi),
        prim_kind=jnp.asarray(packed.prim_kind),
        prim_ctm=jnp.asarray(packed.prim_ctm),
        prim_ctm_inv=jnp.asarray(packed.prim_ctm_inv),
        prim_mat=jnp.asarray(packed.prim_mat),
        num_tris=packed.num_tris,
        num_analytic=packed.num_analytic,
        bvh_depth=bvh_depth(packed.bvh),
        max_leaf_size=max(packed.bvh.max_leaf_size, 1),
    )


def _analytic_material(attrs: dict[str, dict[str, str]]) -> ObjMaterial:
    """Material for an analytic primitive from its XML attributes.

    Maps the scenefile's phong attributes (<diffuse>, <specular>,
    <shininess>, <emissive>) onto the MTL-style record the integrator uses.
    """

    def rgb(tag: str, default=(0.0, 0.0, 0.0)):
        a = attrs.get(tag)
        if not a:
            return default
        return (float(a.get("r", 0)), float(a.get("g", 0)), float(a.get("b", 0)))

    shininess = float(attrs.get("shininess", {}).get("v", 0.0))
    ior = float(attrs.get("ior", {}).get("v", 1.5))
    illum = 7.0 if "transparent" in attrs else 2.0
    return ObjMaterial(
        name="analytic",
        Ns=shininess,
        Ni=ior,
        illum=illum,
        Ka=rgb("ambient"),
        Kd=rgb("diffuse", (0.5, 0.5, 0.5)),
        Ks=rgb("specular"),
        Ke=rgb("emissive"),
    )


def scene_from_graph(
    graph: SceneGraph,
    asset_root: str,
    max_leaf: int = 8,
    ctm_mode: str = "compat_ref",
):
    """Load all meshes/primitives referenced by a scene graph and pack them.

    ``ctm_mode="compat_ref"`` (default) reproduces the reference's vertex
    transform (parse-obj.ts:24 — translations dropped), which both golden
    image sets bake in; pass "correct" for proper CTM application.
    """
    meshes = []
    analytic = []
    for prim in graph.primitives:
        if prim.kind == "mesh":
            if not prim.filename:
                raise ValueError(f"mesh primitive {prim.name!r} missing filename")
            path = os.path.join(asset_root, prim.filename)
            meshes.append(load_obj(path, ctm=prim.ctm, ctm_mode=ctm_mode))
        else:
            analytic.append((prim.kind, prim.ctm, _analytic_material(prim.attributes)))
    mesh = merge_meshes(meshes) if meshes else None
    packed = pack_scene(mesh, analytic, max_leaf=max_leaf)
    return _to_device(packed), graph.camera


def resolve_scene_path(ini_path: str, scene_ref: str, scene_root: str | None) -> str:
    """Resolve an INI ``scene`` reference (server-root-relative in the
    reference, e.g. ``/scene_assets/CornellBox.xml``) to a real path."""
    ref = scene_ref.lstrip("/")
    candidates = []
    if scene_root:
        candidates.append(os.path.join(scene_root, ref))
    ini_dir = os.path.dirname(os.path.abspath(ini_path))
    probe = ini_dir
    for _ in range(4):
        candidates.append(os.path.join(probe, ref))
        probe = os.path.dirname(probe)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"cannot resolve scene {scene_ref!r} from {ini_path!r}")


def load_scene(
    ini_path: str,
    scene_root: str | None = None,
    max_leaf: int = 8,
    ctm_mode: str = "compat_ref",
    **setting_overrides,
) -> tuple[Scene, Camera, RenderSettings, IniScene]:
    """Full frontend: INI file -> (Scene, Camera, RenderSettings, IniScene)."""
    ini = load_ini(ini_path)
    xml_path = resolve_scene_path(ini_path, ini.scene, scene_root)
    graph = load_scenegraph(xml_path)
    asset_root = os.path.dirname(xml_path)
    scene, camera = scene_from_graph(
        graph, asset_root, max_leaf=max_leaf, ctm_mode=ctm_mode
    )
    settings = RenderSettings.from_ini(ini, **setting_overrides)
    return scene, camera, settings, ini
