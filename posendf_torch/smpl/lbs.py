"""SMPL in PyTorch: shape and pose blendshapes, joint regression, forward
kinematics over the 24-joint tree and linear blend skinning.

Mirror of ``posendf_tpu/smpl/lbs.py`` (itself the capability of the smplx.SMPL
dependency the reference wraps, ``experiments/body_model.py:11-53``). The
forward kinematics walks the tree a dependency level at a time (9 levels,
``kinematics.level_schedule``), each level's rotations and translations one
batched product of 3 x 3 and 3-vector pairs (no 4 x 4 homogeneous matrices).
Each level's results are collected and stacked once: no indexed in-place
write into a tensor autograd saved. Differentiable end to end in the pose,
the global orientation and the betas.

SMPL model files are licensed and cannot ship: ``load_smpl_model`` reads the
user's own ``.pkl`` or ``.npz``; ``synthetic_model`` fabricates a structured
stand-in, the same arrays as the JAX package's for the same seed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from posendf_torch.kinematics import SMPL_FULL_PARENTS, level_schedule
from posendf_torch.quat import axis_angle_to_matrix

__all__ = ["NUM_JOINTS", "SMPL_VERTEX_LANDMARKS", "with_landmarks", "SMPLModel",
           "load_smpl_model", "synthetic_model", "lbs_forward"]

NUM_JOINTS = 24


@dataclasses.dataclass
class SMPLModel:
    """SMPL model tensors, all on one device; ``faces`` stays a host array."""

    v_template: torch.Tensor     # (V, 3)
    shapedirs: torch.Tensor      # (V, 3, n_betas)
    posedirs: torch.Tensor       # (207, V*3): pose-feature-major, one product
    j_regressor: torch.Tensor    # (24, V)
    lbs_weights: torch.Tensor    # (V, 24)
    faces: np.ndarray            # (F, 3) int32
    parents: Tuple[int, ...] = SMPL_FULL_PARENTS

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SMPLModel":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
                               "lbs_weights")})


def _model_from_numpy(v_template, shapedirs, posedirs, j_regressor, lbs_weights, faces,
                      parents, device, dtype=torch.float32) -> SMPLModel:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return SMPLModel(v_template=t(v_template), shapedirs=t(shapedirs), posedirs=t(posedirs),
                     j_regressor=t(j_regressor), lbs_weights=t(lbs_weights),
                     faces=np.asarray(faces, np.int32), parents=tuple(int(p) for p in parents))


def load_smpl_model(path: str, num_betas: int = 10, device="cpu",
                    dtype=torch.float32) -> SMPLModel:
    """Load a user-provided SMPL model file (chumpy-style ``.pkl`` or ``.npz``)
    onto ``device``."""
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")

    def arr(x):
        # chumpy arrays expose .r; scipy sparse matrices expose .todense
        if hasattr(x, "r"):
            x = x.r
        if hasattr(x, "todense"):
            x = np.asarray(x.todense())
        return np.asarray(x, dtype=np.float64)

    v_template = arr(data["v_template"])
    shapedirs = arr(data["shapedirs"])[..., :num_betas]
    V = v_template.shape[0]
    posedirs = arr(data["posedirs"]).reshape(V * 3, -1).T   # (V, 3, 207) -> (207, V*3)
    faces = data.get("f", data.get("faces"))
    kintree = data.get("kintree_table")
    if kintree is not None:
        p = np.asarray(kintree)[0].astype(np.int64)
        p[0] = -1
        parents = tuple(int(x) for x in p)
    else:
        parents = SMPL_FULL_PARENTS
    return _model_from_numpy(v_template, shapedirs, posedirs, arr(data["J_regressor"]),
                             arr(data["weights"]), faces, parents, device, dtype)


def synthetic_model(num_vertices: int = 128, num_betas: int = 10, seed: int = 0,
                    device="cpu") -> SMPLModel:
    """Small structured stand-in for tests: joints on a plausible skeleton,
    vertices clustered around joints with soft weights. The numpy draws are
    the JAX package's, in its order, so the arrays are its bits."""
    rng = np.random.default_rng(seed)
    # skeleton rest positions: random bone offsets chained down the tree
    j_rest = np.zeros((NUM_JOINTS, 3))
    j_rest[0] = rng.normal(scale=0.05, size=3)
    for j in range(1, NUM_JOINTS):
        j_rest[j] = j_rest[SMPL_FULL_PARENTS[j]] + rng.normal(scale=0.15, size=3)

    owner = rng.integers(0, NUM_JOINTS, num_vertices)
    v_template = j_rest[owner] + rng.normal(scale=0.08, size=(num_vertices, 3))

    # soft skinning weights from the distance to every joint
    d = np.linalg.norm(v_template[:, None] - j_rest[None], axis=-1)  # (V, 24)
    w = np.exp(-(d / 0.1) ** 2) + 1e-6
    lbs_weights = w / w.sum(axis=1, keepdims=True)

    # an exact joint regressor: one marker vertex placed at each joint
    j_regressor = np.zeros((NUM_JOINTS, num_vertices))
    marker = rng.choice(num_vertices, NUM_JOINTS, replace=False)
    v_template[marker] = j_rest
    j_regressor[np.arange(NUM_JOINTS), marker] = 1.0
    lbs_weights[marker] = np.eye(NUM_JOINTS)[np.arange(NUM_JOINTS)]

    shapedirs = rng.normal(scale=0.01, size=(num_vertices, 3, num_betas))
    shapedirs[marker] = 0.0  # keeps the regressor exact under shape change
    posedirs = rng.normal(scale=0.001, size=(num_vertices * 3, 207)).T

    faces = rng.integers(0, num_vertices, (64, 3)).astype(np.int32)
    return _model_from_numpy(v_template, shapedirs, posedirs, j_regressor, lbs_weights,
                             faces, SMPL_FULL_PARENTS, device)


# smplx's VertexJointSelector appends 21 vertex-picked landmarks after the 24
# skeleton joints (smplx/vertex_joint_selector.py, vertex_ids['smplh']; order:
# 5 face, 6 feet, 10 finger tips). The reference experiments consume the full
# 45-joint Jtr (the denoise data term, motion_denoise.py:93; the kNN joint
# index reads Jtr[:, :25], prepare_traindata.py:147). Ids of the standard
# 6890-vertex SMPL mesh.
SMPL_VERTEX_LANDMARKS = np.array([
    332, 6260, 2800, 4071, 583,                    # nose reye leye rear lear
    3216, 3226, 3387, 6617, 6624, 6787,            # L/R BigToe SmallToe Heel
    2746, 2319, 2445, 2556, 2673,                  # left  thumb..pinky tips
    6191, 5782, 5905, 6016, 6133,                  # right thumb..pinky tips
])


def with_landmarks(vertices: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (B, 24, 3) -> (B, 45, 3) smplx-ordered joints when the mesh
    is as large as a real SMPL body (the landmark ids in range); the skeleton
    joints unchanged for smaller meshes."""
    if vertices.shape[1] > int(SMPL_VERTEX_LANDMARKS.max()):
        return torch.cat([joints, vertices[:, _landmark_ids(vertices.device), :]], dim=1)
    return joints


@functools.lru_cache(maxsize=8)
def _landmark_ids(device: torch.device) -> torch.Tensor:
    """``SMPL_VERTEX_LANDMARKS`` on ``device``, copied there once."""
    return torch.as_tensor(SMPL_VERTEX_LANDMARKS, device=device)


@functools.lru_cache(maxsize=16)
def _fk_plan(parents: Tuple[int, ...], device: torch.device):
    """The forward kinematics' index tensors on ``device``, made once: the
    roots; per later level (its joints, their parents, the parents'
    positions among the joints of the levels before it, in level order);
    and each joint's position in level order."""
    def idx(xs):
        return torch.tensor(list(xs), dtype=torch.long, device=device)

    levels = level_schedule(parents)
    level_order = [j for js, _ in levels for j in js]
    pos = {j: i for i, j in enumerate(level_order)}
    plan = tuple((idx(js), idx(ps), idx(pos[p] for p in ps)) for js, ps in levels[1:])
    return idx(levels[0][0]), plan, idx(pos[j] for j in range(len(parents)))


def lbs_forward(model: SMPLModel, betas: torch.Tensor, global_orient: torch.Tensor,
                body_pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vertices (B, V, 3), joints (B, 24, 3)) of ``body_pose`` (B, 69)
    axis-angle (23 joints), ``global_orient`` (B, 3) and ``betas``.

    The joints are the 24 posed skeleton joints (``with_landmarks`` appends
    smplx's 21 landmarks for a real mesh). ``betas`` may be per-frame
    (B, n_betas) or per-subject, (1, n_betas) or (n_betas,), broadcast over
    the frames as the reference's smplx wrapper does.
    """
    B = body_pose.shape[0]
    if betas.dim() == 1:
        betas = betas[None]
    if betas.shape[0] == 1 and B > 1:
        betas = betas.expand((B,) + tuple(betas.shape[1:]))
    if betas.shape[0] != B:
        raise ValueError(
            f"betas batch {betas.shape[0]} does not match pose batch {B} "
            "(pass per-frame betas, or (1, n_betas)/(n_betas,) to broadcast)")
    full_pose = torch.cat([global_orient.reshape(B, 1, 3), body_pose.reshape(B, 23, 3)], dim=1)
    rot = axis_angle_to_matrix(full_pose)  # (B, 24, 3, 3)

    # shape blendshapes and joint regression
    v_shaped = model.v_template[None] + torch.einsum("vdk,bk->bvd", model.shapedirs, betas)
    joints_rest = torch.einsum("jv,bvd->bjd", model.j_regressor, v_shaped)

    # pose blendshapes: (R_j - I) for j >= 1, flattened to 207
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    pose_feature = (rot[:, 1:] - eye).reshape(B, 207)
    v_posed = v_shaped + torch.matmul(pose_feature, model.posedirs).reshape(B, -1, 3)

    # forward kinematics, a level of the tree at a time: each level's parents
    # gathered from the levels before it in one index, its rotations and
    # positions one product each; the joints back in their order at the end
    roots, plan, order = _fk_plan(tuple(model.parents), rot.device)
    R_lv = [rot[:, roots]]              # each level's global rotations (B, n, 3, 3)
    t_lv = [joints_rest[:, roots]]      # and posed positions (B, n, 3)
    for js, ps, parent_pos in plan:
        Rp = torch.cat(R_lv, dim=1)[:, parent_pos]
        tp = torch.cat(t_lv, dim=1)[:, parent_pos]
        offset = joints_rest[:, js] - joints_rest[:, ps]
        R_lv.append(torch.matmul(Rp, rot[:, js]))
        t_lv.append(tp + torch.matmul(Rp, offset[..., None])[..., 0])
    Rg = torch.cat(R_lv, dim=1)[:, order]     # (B, J, 3, 3)
    tg = torch.cat(t_lv, dim=1)[:, order]     # (B, J, 3)

    # skinning: x -> Rg_j (x - j_rest_j) + tg_j, blended by the weights
    t_skin = tg - torch.matmul(Rg, joints_rest[..., None])[..., 0]
    R_blend = torch.einsum("vj,bjik->bvik", model.lbs_weights, Rg)
    t_blend = torch.einsum("vj,bji->bvi", model.lbs_weights, t_skin)
    # one 3 x 3 product a vertex: elementwise, not a batched GEMM of 3 x 3s
    vertices = torch.sum(R_blend * v_posed[..., None, :], dim=-1) + t_blend
    return vertices, tg
