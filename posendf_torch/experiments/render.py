"""Host-side mesh export and diagnostic rendering.

A copy of ``posendf_tpu/experiments/render.py`` (the port imports nothing of
the JAX package); the body model's vertices come to the host as numpy. The reference's pytorch3d visualization path
(``experiments/exp_utils.py:30-63``: save_obj and a 256x256 SoftPhongShader
render per result mesh, a point light at (0, 0, 3), a distance-2 look-at
view, white vertex colors) is diagnostics, not product, so it stays off the
device: plain-text OBJ export and a small dependency-free NumPy software
rasterizer, ``shading='phong'`` by default (per-pixel interpolated vertex
normals, point-light ambient/diffuse/specular with pytorch3d's default
material coefficients, RGB like the reference) or ``shading='flat'`` for
the grayscale z-buffer diagnostic, written as PNGs through PIL when it is
installed and as .npy otherwise (PIL is imported only then).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = ["save_obj", "save_meshes", "render_mesh", "render_meshes",
           "export_pose_meshes"]


def export_pose_meshes(out_dir: str, body_model, named_poses, *,
                       save_mesh: bool = True, render: bool = False,
                       betas=None, global_orient=None) -> None:
    """SMPL-forward each named pose set and write OBJ meshes and/or PNG
    renders — the reference's per-experiment visualization step
    (``motion_denoise.py:61,112``, ``sample_poses.py:59-62,79-82``,
    ``exp_utils.py:30-63``), shared by the generate/denoise/partial/fit-image
    CLIs.

    Args:
        body_model: a ``posendf_torch.smpl.BodyModel``.
        named_poses: iterable of ``(prefix, pose_body)`` with pose_body
            (B, 63|69) axis-angle, a tensor or numpy; prefixes become the
            mesh/render filename stems (reference uses init/out).
    """
    import torch

    os.makedirs(out_dir, exist_ok=True)
    for prefix, pose_body in named_poses:
        with torch.no_grad():
            res = body_model(pose_body=pose_body, betas=betas,
                             root_orient=global_orient)
        verts = res.vertices.cpu().numpy()
        if save_mesh:
            save_meshes(out_dir, verts, res.faces, prefix=prefix)
        if render:
            render_meshes(out_dir, verts, res.faces, prefix=prefix)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def save_meshes(out_dir: str, vertices: np.ndarray, faces: np.ndarray,
                prefix: str = "out") -> Sequence[str]:
    """(B, V, 3) -> out_dir/meshes/{prefix}_{i:04d}.obj (reference naming,
    ``sample_poses.py:52``)."""
    mesh_dir = os.path.join(out_dir, "meshes")
    os.makedirs(mesh_dir, exist_ok=True)
    paths = []
    for i, v in enumerate(np.asarray(vertices)):
        p = os.path.join(mesh_dir, f"{prefix}_{i:04d}.obj")
        save_obj(p, v, faces)
        paths.append(p)
    return paths


def _look_at(eye, target, up=(0.0, 1.0, 0.0)):
    eye, target, up = (np.asarray(x, np.float64) for x in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    R = np.stack([right, true_up, -fwd])  # world -> camera
    t = -R @ eye
    return R, t


def _vertex_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (the standard smooth-shading normals
    pytorch3d's Meshes.verts_normals computes)."""
    tri = V[F]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])  # (F, 3)
    vn = np.zeros_like(V)
    for k in range(3):
        np.add.at(vn, F[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.where(norm < 1e-12, 1.0, norm)


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    image_size: int = 256,
    eye=(0.0, 0.3, 2.0),
    fov_deg: float = 60.0,
    light_dir=(0.3, 0.5, 1.0),
    shading: str = "phong",
    light_pos=(0.0, 0.0, 3.0),
) -> np.ndarray:
    """Z-buffered software render.

    ``shading='phong'`` (default): per-pixel interpolated vertex normals
    lit by a point light at ``light_pos`` (mesh-centered coordinates) with
    pytorch3d's default Phong coefficients (ambient 0.5, diffuse 0.3,
    specular 0.2, shininess 64) on a white material — the reference's
    SoftPhongShader setup (``exp_utils.py:43,51-55``). Returns (S, S, 3)
    RGB in [0, 1]. ``shading='flat'``: the legacy grayscale per-face
    diagnostic, (S, S) in [0, 1].
    """
    if shading not in ("phong", "flat"):
        raise ValueError(f"shading must be 'phong' or 'flat', got {shading!r}")
    V = np.asarray(vertices, np.float64)
    F = np.asarray(faces, np.int64)
    center = V.mean(axis=0)
    eye_w = np.asarray(eye) + center
    R, t = _look_at(eye_w, center)
    cam = V @ R.T + t
    f = 0.5 * image_size / np.tan(np.radians(fov_deg) / 2)
    z = -cam[:, 2]
    z = np.where(z < 1e-6, 1e-6, z)
    px = f * cam[:, 0] / z + image_size / 2
    py = -f * cam[:, 1] / z + image_size / 2

    # face normals (flat shade + degenerate cull)
    tri = V[F]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.where(norm < 1e-12, 1.0, norm)
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)
    shade = 0.2 + 0.8 * np.abs(n @ ld)

    phong = shading == "phong"
    if phong:
        vn = _vertex_normals(V, F)
        lp = np.asarray(light_pos, np.float64) + center
        img = np.zeros((image_size, image_size, 3), np.float64)
    else:
        img = np.zeros((image_size, image_size), np.float64)
    zbuf = np.full((image_size, image_size), np.inf)
    txy = np.stack([px[F], py[F]], axis=-1)  # (F, 3, 2)
    tz = z[F].mean(axis=1)
    order = np.argsort(-tz)  # far-to-near is fine with z-test; near-first is faster

    for fi in order:
        p = txy[fi]
        x0, y0 = np.floor(p.min(axis=0)).astype(int)
        x1, y1 = np.ceil(p.max(axis=0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, image_size - 1), min(y1, image_size - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        # barycentric test
        (ax, ay), (bx, by), (cx, cy) = p
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-12:
            continue
        w0 = ((by - cy) * (xs - cx) + (cx - bx) * (ys - cy)) / den
        w1 = ((cy - ay) * (xs - cx) + (ax - cx) * (ys - cy)) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        depth = tz[fi]
        closer = inside & (depth < zbuf[y0:y1 + 1, x0:x1 + 1])
        if not closer.any():
            continue
        zbuf[y0:y1 + 1, x0:x1 + 1][closer] = depth
        if not phong:
            img[y0:y1 + 1, x0:x1 + 1][closer] = shade[fi]
            continue
        # Phong: interpolate world position + vertex normal per pixel
        # (screen-space barycentrics — perspective-correct enough for the
        # diagnostics view distance), then ambient+diffuse+specular with a
        # point light, white material
        i0, i1, i2 = F[fi]
        wsel = np.stack([w0[closer], w1[closer], w2[closer]], axis=-1)
        pos = wsel @ np.stack([V[i0], V[i1], V[i2]])           # (P, 3)
        nrm = wsel @ np.stack([vn[i0], vn[i1], vn[i2]])        # (P, 3)
        nn = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.where(nn < 1e-12, 1.0, nn)
        l = lp[None] - pos
        l /= np.maximum(np.linalg.norm(l, axis=1, keepdims=True), 1e-12)
        ndotl = np.sum(nrm * l, axis=1)
        # double-sided like SoftPhongShader on unoriented meshes
        sign = np.where(ndotl < 0, -1.0, 1.0)
        nrm = nrm * sign[:, None]
        ndotl = ndotl * sign
        view = eye_w[None] - pos
        view /= np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-12)
        refl = 2.0 * ndotl[:, None] * nrm - l
        spec = np.clip(np.sum(refl * view, axis=1), 0.0, 1.0) ** 64
        intensity = np.clip(0.5 + 0.3 * np.clip(ndotl, 0.0, 1.0)
                            + 0.2 * spec, 0.0, 1.0)
        img[y0:y1 + 1, x0:x1 + 1][closer] = intensity[:, None]
    return img


def render_meshes(out_dir: str, vertices: np.ndarray, faces: np.ndarray,
                  prefix: str = "out", image_size: int = 256,
                  shading: str = "phong") -> Sequence[str]:
    """(B, V, 3) -> out_dir/render/{prefix}_{i:04d}.png (reference layout,
    ``exp_utils.py:31,63``; Phong-shaded RGB by default like the
    reference's SoftPhongShader output, ``shading='flat'`` for the
    grayscale diagnostic)."""
    render_dir = os.path.join(out_dir, "render")
    os.makedirs(render_dir, exist_ok=True)
    paths = []
    for i, v in enumerate(np.asarray(vertices)):
        img = render_mesh(v, faces, image_size=image_size, shading=shading)
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        try:
            from PIL import Image
        except ImportError:
            p = os.path.join(render_dir, f"{prefix}_{i:04d}.npy")
            np.save(p, arr)
        else:
            p = os.path.join(render_dir, f"{prefix}_{i:04d}.png")
            Image.fromarray(arr).save(p)
        paths.append(p)
    return paths
