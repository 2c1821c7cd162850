"""Procedural test scenes (no file IO).

A self-contained Cornell-style box used by tests, benchmarks, and
``__graft_entry__`` so they never depend on external assets. Geometry and
material values mirror the CornellBox-Original layout the reference renders
(scene_assets/models/CornellBox/CornellBox-Original.obj semantics: red/green
side walls, white floor/ceiling/back, two boxes, one warm area light).

``mesh_scene`` puts a seeded tessellated object of any triangle count in the
same room: the large-mesh stand-in for the reference's MedievalBoat
(12.6k triangles), built from a seed instead of read from disk.
"""

from __future__ import annotations

import numpy as np

from pathtracer_tpu.models.camera import Camera
from pathtracer_tpu.models.obj import ObjMaterial, ObjMesh
from pathtracer_tpu.models.pack import pack_scene


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise winding)."""
    return [(a, b, c), (a, c, d)]


def _box_quads(lo, hi, inward: bool = False):
    """12 triangles for an axis-aligned box; ``inward`` flips winding."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    # Eight corners.
    c = {
        (0, 0, 0): (x0, y0, z0),
        (1, 0, 0): (x1, y0, z0),
        (0, 1, 0): (x0, y1, z0),
        (1, 1, 0): (x1, y1, z0),
        (0, 0, 1): (x0, y0, z1),
        (1, 0, 1): (x1, y0, z1),
        (0, 1, 1): (x0, y1, z1),
        (1, 1, 1): (x1, y1, z1),
    }
    faces = [
        # -z, +z, -x, +x, -y, +y (outward winding)
        _quad(c[0, 0, 0], c[0, 1, 0], c[1, 1, 0], c[1, 0, 0]),
        _quad(c[0, 0, 1], c[1, 0, 1], c[1, 1, 1], c[0, 1, 1]),
        _quad(c[0, 0, 0], c[0, 0, 1], c[0, 1, 1], c[0, 1, 0]),
        _quad(c[1, 0, 0], c[1, 1, 0], c[1, 1, 1], c[1, 0, 1]),
        _quad(c[0, 0, 0], c[1, 0, 0], c[1, 0, 1], c[0, 0, 1]),
        _quad(c[0, 1, 0], c[0, 1, 1], c[1, 1, 1], c[1, 1, 0]),
    ]
    tris = [t for f in faces for t in f]
    if inward:
        tris = [(a, c_, b) for a, b, c_ in tris]
    return tris


_CORNELL_MATERIALS = (
    ObjMaterial(name="white", Ns=10, illum=2, Kd=(0.725, 0.71, 0.68)),
    ObjMaterial(name="red", Ns=10, illum=2, Kd=(0.63, 0.065, 0.05)),
    ObjMaterial(name="green", Ns=10, illum=2, Kd=(0.14, 0.45, 0.091)),
    ObjMaterial(
        name="light", Ns=10, illum=2, Kd=(0.78, 0.78, 0.78), Ke=(17.0, 12.0, 4.0)
    ),
)


def _room_tris():
    """(triangles, material ids) of the walls and the light (12 tris)."""
    tris: list[tuple] = []
    mat_ids: list[int] = []

    def add(tlist, mat):
        tris.extend(tlist)
        mat_ids.extend([mat] * len(tlist))

    # Room interior (x in [-1, 1], y in [0, 2], z in [-1, 1]); open front.
    add(_quad((-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)), 0)  # floor
    add(_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)), 0)  # ceiling
    add(_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), 0)  # back
    add(_quad((-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1)), 1)  # left red
    add(_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), 2)  # right green
    # Light quad just below the ceiling, emitting downward: winding chosen
    # so cross(b-a, c-a) points -y (NEE weights contributions by the
    # light-side cosine, so an upward normal blacks out the room).
    add(_quad((-0.24, 1.98, -0.22), (0.23, 1.98, -0.22),
              (0.23, 1.98, 0.16), (-0.24, 1.98, 0.16)), 3)
    return tris, mat_ids


def _indexed_mesh(tris, mat_ids, mats) -> ObjMesh:
    """ObjMesh from per-triangle vertex tuples (shared vertices merged)."""
    verts: list[tuple] = []
    index: dict[tuple, int] = {}
    faces = []
    for tri in tris:
        ids = []
        for v in tri:
            if v not in index:
                index[v] = len(verts)
                verts.append(v)
            ids.append(index[v])
        faces.append(ids)

    return ObjMesh(
        positions=np.asarray(verts, dtype=np.float64),
        normals=np.zeros((0, 3)),
        faces=np.asarray(faces, dtype=np.int32),
        face_normals=np.full((len(faces), 3), -1, dtype=np.int32),
        face_material=np.asarray(mat_ids, dtype=np.int32),
        materials=list(mats),
    )


def cornell_box_mesh(glossy_tall_box: bool = False) -> ObjMesh:
    """A 36-triangle Cornell-style box (walls, two boxes, area light).

    ``glossy_tall_box``: give the tall box its own Phong-glossy material
    (Ks > 0, Ns = 40 — the reference's glossy lobe parameters,
    program-raymarch.wgsl:262-278) so roughness/specular gradients have a
    visible surface to fit (tests/test_inverse_roughness.py).
    """
    mats = list(_CORNELL_MATERIALS)
    tall_mat = 0
    if glossy_tall_box:
        tall_mat = len(mats)
        mats.append(
            ObjMaterial(
                name="glossy", Ns=40, illum=2,
                Kd=(0.2, 0.2, 0.2), Ks=(0.6, 0.6, 0.6),
            )
        )
    tris, mat_ids = _room_tris()
    # Two boxes.
    tris += _box_quads((-0.55, 0.0, -0.55), (0.0, 1.2, -0.05))  # tall
    mat_ids += [tall_mat] * 12
    tris += _box_quads((0.1, 0.0, 0.05), (0.65, 0.6, 0.6))  # short
    mat_ids += [0] * 12
    return _indexed_mesh(tris, mat_ids, mats)


def cornell_box_scene(max_leaf: int = 8, glossy_tall_box: bool = False):
    """(Scene, Camera) for the procedural Cornell box."""
    from pathtracer_tpu.models.scene import _to_device

    packed = pack_scene(
        cornell_box_mesh(glossy_tall_box=glossy_tall_box), max_leaf=max_leaf
    )
    return _to_device(packed), _cornell_camera()


def _cornell_camera() -> Camera:
    return Camera(
        pos=(0.0, 1.0, 3.6),
        up=(0.0, 1.0, 0.0),
        focus=(0.0, 1.0, 0.0),
        height_angle_deg=45.0,
    )


def bumpy_torus(n_tris: int, seed: int = 0):
    """Seeded closed torus of about ``n_tris`` triangles -> (V [N, 3], F).

    An nu x nv quad grid (2 * nu * nv triangles, nu ~ 3 nv) whose tube
    radius carries a smooth seeded bump field (a few integer-frequency
    sinusoids, so the grid wraps seamlessly), randomly tilted and centred
    in the Cornell room's free space.
    """
    rng = np.random.default_rng(seed)
    nv = max(3, int(round(np.sqrt(n_tris / 6.0))))
    nu = max(3, n_tris // (2 * nv))
    u = np.arange(nu) * (2.0 * np.pi / nu)
    v = np.arange(nv) * (2.0 * np.pi / nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # [nu, nv]

    bump = np.zeros_like(uu)
    for _ in range(6):
        fu, fv = rng.integers(1, 9), rng.integers(1, 6)
        bump += np.sin(fu * uu + fv * vv + rng.uniform(0, 2 * np.pi))
    big_r, small_r = 0.55, 0.2
    r = small_r * (1.0 + 0.08 * bump)
    pts = np.stack(
        [
            (big_r + r * np.cos(vv)) * np.cos(uu),
            r * np.sin(vv),
            (big_r + r * np.cos(vv)) * np.sin(uu),
        ],
        axis=-1,
    ).reshape(-1, 3)

    # Random tilt (rotation about x, then y), then centre in the room.
    ax, ay = rng.uniform(0.3, 1.2), rng.uniform(0.0, 2.0 * np.pi)
    rot_x = np.array(
        [[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]]
    )
    rot_y = np.array(
        [[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]]
    )
    pts = pts @ (rot_y @ rot_x).T + np.array([0.0, 0.95, 0.0])

    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.concatenate(
        [np.stack([a, b, c], -1).reshape(-1, 3),
         np.stack([a, c, d], -1).reshape(-1, 3)]
    )
    return pts, faces.astype(np.int32)


def mesh_scene(n_tris: int = 12_600, seed: int = 0, max_leaf: int = 8):
    """(Scene, Camera): the Cornell room (walls + light, no boxes) holding
    a seeded bumpy torus of about ``n_tris`` triangles (``bumpy_torus``),
    the whole scene having about ``n_tris + 12`` triangles."""
    from pathtracer_tpu.models.scene import _to_device

    room = _indexed_mesh(*_room_tris(), _CORNELL_MATERIALS)
    pts, faces = bumpy_torus(n_tris, seed)
    n_room = len(room.positions)
    mesh = ObjMesh(
        positions=np.concatenate([room.positions, pts]),
        normals=np.zeros((0, 3)),
        faces=np.concatenate([room.faces, faces + n_room]).astype(np.int32),
        face_normals=np.full((len(room.faces) + len(faces), 3), -1, np.int32),
        face_material=np.concatenate(
            [room.face_material, np.zeros(len(faces), np.int32)]
        ),
        materials=list(_CORNELL_MATERIALS),
    )
    return _to_device(pack_scene(mesh, max_leaf=max_leaf)), _cornell_camera()
