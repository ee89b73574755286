"""Quaternion and rotation operations.

Mirror of ``posendf_tpu/quat.py``: the closed-form replacements for the
rotation conversions the reference takes from pytorch3d.transforms, the
double-cover helpers, the geodesic pose distances and slerp. Conventions are
pytorch3d's, so labelled data and checkpoints cross over unchanged:

  * quaternions are ``(w, x, y, z)``, real part first;
  * half-angle formulas, with a Taylor branch at small angles;
  * no implicit canonicalization (``quat_flip`` is separate).

Every function works on the trailing axis and broadcasts over leading
axes. Where a formula is singular (a norm at zero, arccos at 1) the unsafe
operand is itself made safe before the ``torch.where`` that picks the
branch ("double where"): a single ``torch.where`` still sends a NaN
gradient through the branch it did not take. Solvers start at the zero
rotation (zero-padded hand dofs, clean synthetic clips), so those
gradients must stay finite.

The two normalizations divide by ``sqrt(max(sum of squares, eps^2))``, so
their gradient is finite at zero.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_matrix",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "matrix_to_rotation_6d",
    "rotation_6d_to_matrix",
    "quat_flip",
    "quat_normalize",
    "joint_axis_normalize",
    "quat_conjugate",
    "quat_multiply",
    "quat_geodesic_distance",
    "weighted_quat_geodesic_distance",
    "quat_slerp",
    "SMPL_JOINT_RANK",
    "JOINT_WEIGHTS",
]

# Per-joint importance ranks of the weighted distance (the reference's
# joint_rank, data/dist_utils.py:16,39), and their L2-normalized float32 form,
# the weights every weighted kNN search and label uses.
SMPL_JOINT_RANK = torch.tensor([7, 7, 7, 6, 6, 6, 5, 5, 5, 4, 4, 4, 4, 4, 3, 3, 3, 2, 2, 1, 1],
                               dtype=torch.float32)
JOINT_WEIGHTS = SMPL_JOINT_RANK / torch.linalg.norm(SMPL_JOINT_RANK)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize each quaternion (trailing axis) to unit norm; zero stays zero."""
    n = torch.sum(q * q, dim=-1, keepdim=True).clamp_min(eps * eps).sqrt()
    return q / n


def joint_axis_normalize(pose: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The reference's ``F.normalize(pose, dim=1)`` quirk.

    A (B, 21, 4) pose is normalized across the JOINT axis: each (batch,
    component) column over the 21 joints, not each quaternion. Trained
    checkpoints bake this in.
    """
    n = torch.sum(pose * pose, dim=1, keepdim=True).clamp_min(eps * eps).sqrt()
    return pose / n


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4), (w, x, y, z).

    pytorch3d's convention: q = [cos(t/2), sin(t/2) axis], with sin(t/2)/t
    and cos(t/2) taken from their Taylor series below t = 1e-6, written as
    the JAX package writes it (the square root's argument guarded, so the
    gradient is finite at the zero rotation).
    """
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    sin_half_over_angle = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, aa * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> axis-angle (..., 3): angle = 2 atan2(|xyz|, w).

    For tiny |xyz| with w > 0 the angle is about 2 |xyz| / w, so the Taylor
    branch uses angle^2 = 4 |xyz|^2 / w^2 and never differentiates the
    square root at 0.
    """
    w = q[..., :1]
    xyz = q[..., 1:]
    sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = (sq < 1e-12) & (w > 0)
    norms = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half_angle = torch.atan2(norms, w)
    angle = 2.0 * half_angle
    angle_sq_small = 4.0 * sq / torch.clamp_min(w * w, 1e-12)
    sin_half_over_angle = torch.where(
        small, 0.5 - angle_sq_small / 48.0,
        torch.sin(half_angle) / torch.where(small, torch.ones_like(angle), angle))
    return xyz / sin_half_over_angle


# quaternion_to_matrix's entries, row-major: R = I + two_s (sa q_a q_b + sc q_c q_d),
# each the two products of pytorch3d's formula, taken from the flattened q q^T
# (w, x, y, z = 0..3): ((a, b, sa), (c, d, sc))
_Q2M_TERMS = (
    ((2, 2, -1.0), (3, 3, -1.0)), ((1, 2, 1.0), (3, 0, -1.0)), ((1, 3, 1.0), (2, 0, 1.0)),
    ((1, 2, 1.0), (3, 0, 1.0)), ((1, 1, -1.0), (3, 3, -1.0)), ((2, 3, 1.0), (1, 0, -1.0)),
    ((1, 3, 1.0), (2, 0, -1.0)), ((2, 3, 1.0), (1, 0, 1.0)), ((1, 1, -1.0), (2, 2, -1.0)),
)


@functools.lru_cache(maxsize=16)
def _q2m_tables(device: torch.device, dtype: torch.dtype):
    """The index and sign tensors of ``_Q2M_TERMS`` and the flattened
    identity, made once a device (an index from a Python list would be
    copied to the device at every call)."""
    first = [a * 4 + b for (a, b, _), _ in _Q2M_TERMS]
    second = [c * 4 + d for _, (c, d, _) in _Q2M_TERMS]
    signs = [[sa for (_, _, sa), _ in _Q2M_TERMS], [sc for _, (_, _, sc) in _Q2M_TERMS]]
    return (torch.tensor(first, device=device), torch.tensor(second, device=device),
            torch.tensor(signs, dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device).reshape(9))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3), pytorch3d's formula
    (with its 2 / |q|^2 normalization). Each entry sums the formula's two
    products, gathered from q q^T; a product times +-1 is exact, so these
    are the formula's values, in a few launches where the formula's nine
    expressions take some forty (the denoise solve converts 24 joints of
    every frame at every step)."""
    first, second, signs, eye = _q2m_tables(q.device, q.dtype)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    outer = (q[..., :, None] * q[..., None, :]).reshape(q.shape[:-1] + (16,))
    o = outer[..., first] * signs[0] + outer[..., second] * signs[1]
    return (eye + two_s[..., None] * o).reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), via the quaternion."""
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4).

    pytorch3d's branch-free Shepperd method: all four candidate quaternions,
    and the one keyed to the largest squared component is taken.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.stack([
        _sqrt_positive_part(1.0 + m00 + m11 + m22),
        _sqrt_positive_part(1.0 + m00 - m11 - m22),
        _sqrt_positive_part(1.0 - m00 + m11 - m22),
        _sqrt_positive_part(1.0 - m00 - m11 + m22),
    ], dim=-1)
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp_min(q_abs[..., None], 0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(candidates, -2, idx)[..., 0, :]


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6D representation (..., 6): the first
    two rows, flattened (Zhou et al. CVPR'19, pytorch3d's convention)."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D representation (..., 6) -> rotation matrix (..., 3, 3) by
    Gram-Schmidt, the rows b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.sqrt(torch.clamp_min(torch.sum(a1 * a1, -1, keepdim=True), 1e-24))
    a2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = a2 / torch.sqrt(torch.clamp_min(torch.sum(a2 * a2, -1, keepdim=True), 1e-24))
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def quat_flip(q: torch.Tensor) -> torch.Tensor:
    """The w >= 0 hemisphere of the double cover: every quaternion whose real
    part is negative is negated (``model/load_data.py:12-16``)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w, x, y, z), broadcasting over leading axes."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_geodesic_distance(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Mean over joints of 1 - |<qa_j, qb_j>|: (..., J, 4) -> (...,), the
    double-cover-invariant distance of the labels (``data/dist_utils.py:47``)."""
    return torch.mean(1.0 - torch.abs(torch.sum(qa * qb, dim=-1)), dim=-1)


def weighted_quat_geodesic_distance(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """sum_j w_j (1 - |<qa_j, qb_j>|) with w the normalized joint ranks
    (``data/dist_utils.py:45``)."""
    w = JOINT_WEIGHTS.to(qa.device)
    return torch.sum(w * (1.0 - torch.abs(torch.sum(qa * qb, dim=-1))), dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions, the shorter
    way (q1 negated where <q0, q1> < 0), linear where they are nearly
    parallel.

    ``t``: a scalar or (T,) weights. Returns (T,) + broadcast(q0, q1).shape,
    renormalized. arccos is taken of the dot clamped away from 1, and the
    near-parallel pairs take the linear branch, so the gradient stays finite.
    """
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    parallel = dot > 1.0 - 1e-7
    theta = torch.arccos(torch.clamp(dot, -1.0 + 1e-7, 1.0 - 1e-7))
    safe_sin = torch.sin(theta)
    t = torch.atleast_1d(torch.as_tensor(t, dtype=q0.dtype, device=q0.device))
    t = t.reshape((-1,) + (1,) * q0.dim())
    w0 = torch.where(parallel, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(parallel, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(w0 * q0[None] + w1 * q1[None])
