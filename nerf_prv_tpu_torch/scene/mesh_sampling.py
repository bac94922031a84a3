"""Mesh -> colored point cloud sampling (the L0 asset-prep layer).

Self-contained replacement for the reference's ShapeNet_scripts toolchain
(``mesh_sampling_geo_color_shapenet.py`` + ``get_ply_from_mesh.py``), which
chains pymeshlab, a CloudCompare CLI subprocess (``-SAMPLE_MESH POINTS
500000``) and open3d 1024^3 voxelization:

- OBJ/MTL parsing with texture maps (PIL)
- exact-duplicate face removal (the reference's ambient-occlusion pass
  targets z-fighting duplicate faces in ShapeNet; coincident-face removal
  covers the same artifact deterministically)
- area-weighted barycentric surface sampling with bilinear texture lookup
- first-win voxel thinning on a 1024^3-equivalent grid

The sampling math is vectorized numpy (host-side data prep); the batch
runner fans out across threads like ``get_mesh_sampling.py``'s 50-thread
pool.  The port's own copy of ``nerf_prv_tpu/scene/mesh_sampling.py``,
over the port's ``ply`` and ``voxel``: the same seed gives the same points.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ply import save_ply_ascii, save_ply_binary
from .voxel import voxel_downsample


@dataclass
class Material:
    name: str
    kd: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    texture: Optional[np.ndarray] = None  # (H, W, 3) float [0,1]


@dataclass
class Mesh:
    vertices: np.ndarray                  # (V, 3)
    faces: np.ndarray                     # (F, 3) vertex indices
    uvs: Optional[np.ndarray] = None      # (T, 2)
    face_uvs: Optional[np.ndarray] = None  # (F, 3) uv indices, -1 if absent
    face_materials: Optional[np.ndarray] = None  # (F,) material ids
    materials: List[Material] = field(default_factory=list)


def _load_mtl(path: str) -> Dict[str, Material]:
    from PIL import Image

    mats: Dict[str, Material] = {}
    cur: Optional[Material] = None
    base = os.path.dirname(path)
    if not os.path.exists(path):
        return mats
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = Material(name=parts[1])
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif parts[0] == "Kd" and len(parts) >= 4:
                cur.kd = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif parts[0] == "map_Kd":
                tex_path = os.path.join(base, parts[-1].replace("\\", "/"))
                if os.path.exists(tex_path):
                    try:
                        img = Image.open(tex_path).convert("RGB")
                        cur.texture = np.asarray(img, np.float32) / 255.0
                    except OSError:
                        pass
    return mats


def load_obj(path: str) -> Mesh:
    """Minimal OBJ loader: v / vt / f (+ mtllib/usemtl) with fan
    triangulation of polygons."""
    vertices: List[List[float]] = []
    uvs: List[List[float]] = []
    faces: List[List[int]] = []
    face_uvs: List[List[int]] = []
    face_mats: List[int] = []
    materials: List[Material] = [Material("default")]
    mat_index = {"default": 0}
    cur_mat = 0
    base = os.path.dirname(path)
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt" and len(parts) >= 3:
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "mtllib":
                for name, mat in _load_mtl(os.path.join(base, parts[1])).items():
                    if name not in mat_index:
                        mat_index[name] = len(materials)
                        materials.append(mat)
            elif tag == "usemtl":
                cur_mat = mat_index.get(parts[1], 0)
            elif tag == "f" and len(parts) >= 4:
                refs = []
                for p in parts[1:]:
                    comps = p.split("/")
                    vi = int(comps[0])
                    vi = vi - 1 if vi > 0 else len(vertices) + vi
                    ti = -1
                    if len(comps) > 1 and comps[1]:
                        t = int(comps[1])
                        ti = t - 1 if t > 0 else len(uvs) + t
                    refs.append((vi, ti))
                for k in range(1, len(refs) - 1):  # fan triangulation
                    tri = [refs[0], refs[k], refs[k + 1]]
                    faces.append([r[0] for r in tri])
                    face_uvs.append([r[1] for r in tri])
                    face_mats.append(cur_mat)
    return Mesh(
        vertices=np.asarray(vertices, np.float64),
        faces=np.asarray(faces, np.int64).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float64).reshape(-1, 2) if uvs else None,
        face_uvs=np.asarray(face_uvs, np.int64).reshape(-1, 3) if face_uvs else None,
        face_materials=np.asarray(face_mats, np.int64),
        materials=materials,
    )


def remove_duplicate_faces(mesh: Mesh, tol: float = 1e-5) -> Mesh:
    """Drop ShapeNet's z-fighting duplicate geometry (≙ the AO-based pass in
    mesh_sampling_geo_color_shapenet.py:33-101).

    Duplicates are detected on vertex *positions*, not just indices:
    vertices are snapped to a ``tol``-of-bbox-diagonal grid, so offset
    duplicates (re-listed vertices a fraction of a millimeter apart — the
    common ShapeNet export artifact) and rewound duplicates (same triangle,
    reversed winding) collapse onto one canonical key.  Within each
    duplicate group the kept face is the one whose normal points most
    outward from the mesh centroid — a cheap geometric stand-in for the
    reference's keep-the-max-ambient-occlusion rule (its AO quality ranks
    the *visible* copy highest; for closed-ish surfaces that is the
    outward-facing one).  Faces that collapse to fewer than 3 distinct
    snapped vertices (zero area at sampling tolerance) are dropped.
    """
    v = mesh.vertices
    f = mesh.faces
    if len(f) == 0:
        return mesh
    diag = float(np.linalg.norm(v.max(axis=0) - v.min(axis=0))) or 1.0
    q = np.round(v / (tol * diag)).astype(np.int64)
    _, canon = np.unique(q, axis=0, return_inverse=True)
    cf = canon[f]  # (F, 3) canonical vertex ids
    nondegenerate = (
        (cf[:, 0] != cf[:, 1]) & (cf[:, 1] != cf[:, 2]) & (cf[:, 0] != cf[:, 2])
    )
    key = np.sort(cf, axis=1)
    _, group = np.unique(key, axis=0, return_inverse=True)

    # outwardness score ≈ the AO visibility ranking: normal . (centroid - C)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    normal = np.cross(e1, e2)
    centroid = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0
    score = np.einsum("ij,ij->i", normal, centroid - v.mean(axis=0))

    # stable pick: within each group order by (-score, original index)
    order = np.lexsort((np.arange(len(f)), -score, group))
    first_of_group = np.ones(len(f), dtype=bool)
    first_of_group[1:] = group[order][1:] != group[order][:-1]
    keep_mask = np.zeros(len(f), dtype=bool)
    keep_mask[order[first_of_group]] = True
    keep = np.sort(np.nonzero(keep_mask & nondegenerate)[0])
    return Mesh(
        vertices=mesh.vertices,
        faces=mesh.faces[keep],
        uvs=mesh.uvs,
        face_uvs=mesh.face_uvs[keep] if mesh.face_uvs is not None else None,
        face_materials=(
            mesh.face_materials[keep] if mesh.face_materials is not None else None
        ),
        materials=mesh.materials,
    )


def _sample_texture(tex: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear texture lookup; uv in [0,1], v up (OBJ convention)."""
    h, w = tex.shape[:2]
    u = np.mod(uv[:, 0], 1.0) * (w - 1)
    v = (1.0 - np.mod(uv[:, 1], 1.0)) * (h - 1)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    return (
        tex[v0, u0] * (1 - fu) * (1 - fv)
        + tex[v0, u1] * fu * (1 - fv)
        + tex[v1, u0] * (1 - fu) * fv
        + tex[v1, u1] * fu * fv
    )


def sample_mesh(
    mesh: Mesh,
    n_points: int = 500_000,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling with per-sample color.

    ≙ CloudCompare ``-SAMPLE_MESH POINTS 500000``
    (mesh_sampling_geo_color_shapenet.py:240) + texture color transfer
    (get_ply_from_mesh.py).  Returns (points (N,3), colors uint8 (N,3)).
    """
    rng = np.random.default_rng(seed)
    v = mesh.vertices
    tri = v[mesh.faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    fidx = rng.choice(len(area), size=n_points, p=area / total)
    r1 = np.sqrt(rng.random(n_points))
    r2 = rng.random(n_points)
    b0 = 1.0 - r1
    b1 = r1 * (1.0 - r2)
    b2 = r1 * r2
    bary = np.stack([b0, b1, b2], axis=1)  # (N, 3)
    pts = np.einsum("nk,nkd->nd", bary, tri[fidx])

    colors = np.full((n_points, 3), 0.8, np.float32)
    if mesh.face_materials is not None:
        for mid, mat in enumerate(mesh.materials):
            mask = mesh.face_materials[fidx] == mid
            if not mask.any():
                continue
            if (
                mat.texture is not None
                and mesh.uvs is not None
                and mesh.face_uvs is not None
            ):
                fuv = mesh.face_uvs[fidx[mask]]
                valid = (fuv >= 0).all(axis=1)
                uv_tri = mesh.uvs[np.maximum(fuv, 0)]  # (M, 3, 2)
                uv = np.einsum("nk,nkd->nd", bary[mask], uv_tri)
                col = _sample_texture(mat.texture, uv)
                col[~valid] = mat.kd
                colors[mask] = col
            else:
                colors[mask] = mat.kd
    return pts, np.clip(colors * 255.0, 0, 255).astype(np.uint8)


def is_textured(mesh: Mesh) -> bool:
    """The batch runner keeps only textured models
    (≙ get_mesh_sampling.py:33-34 'textured models per category')."""
    return any(m.texture is not None for m in mesh.materials)


def sample_and_voxelize(
    obj_path: str,
    out_ply: str,
    n_points: int = 500_000,
    grid_resolution: int = 1024,
    seed: int = 0,
    require_texture: bool = False,
    binary: bool = True,
) -> bool:
    """One model through the full L0 chain: load, dedupe, sample, voxel-thin
    on a ``grid_resolution``^3 grid over the bbox (≙ open3d voxelization at
    mesh_sampling_geo_color_shapenet.py:246-260), write
    ``model_normalized_sample.ply``."""
    mesh = load_obj(obj_path)
    if len(mesh.faces) == 0:
        return False
    if require_texture and not is_textured(mesh):
        return False
    mesh = remove_duplicate_faces(mesh)
    pts, cols = sample_mesh(mesh, n_points, seed)
    extent = pts.max(axis=0) - pts.min(axis=0)
    res = float(extent.max()) / grid_resolution
    if res > 0:
        centers, vcols, _ = voxel_downsample(pts, cols, res)
    else:
        centers, vcols = pts, cols
    os.makedirs(os.path.dirname(out_ply) or ".", exist_ok=True)
    writer = save_ply_binary if binary else save_ply_ascii
    writer(out_ply, centers, vcols)
    return True


def batch_sample_shapenet(
    shapenet_root: str,
    synset_ids,
    max_models_per_class: int = 1200,
    n_points: int = 500_000,
    grid_resolution: int = 1024,
    workers: int = 8,
) -> List[str]:
    """Batch runner (≙ get_mesh_sampling.py:7-55): walk each synset, sample
    every textured ``model_normalized.obj`` in a worker pool, write
    ``model_normalized_sample.ply`` next to it."""
    jobs = []
    for synset in synset_ids:
        sdir = os.path.join(shapenet_root, synset)
        if not os.path.isdir(sdir):
            continue
        count = 0
        for model_id in sorted(os.listdir(sdir)):
            if count >= max_models_per_class:
                break
            mdir = os.path.join(sdir, model_id)
            obj = os.path.join(mdir, "models", "model_normalized.obj")
            if not os.path.exists(obj):
                obj = os.path.join(mdir, "model_normalized.obj")
                if not os.path.exists(obj):
                    continue
            out = os.path.join(os.path.dirname(obj), "model_normalized_sample.ply")
            jobs.append((obj, out))
            count += 1

    done: List[str] = []

    def work(job):
        obj, out = job
        if os.path.exists(out):
            return out
        try:
            ok = sample_and_voxelize(
                obj, out, n_points, grid_resolution, require_texture=True
            )
            return out if ok else None
        except Exception:
            return None

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for result in pool.map(work, jobs):
            if result:
                done.append(result)
    return done
