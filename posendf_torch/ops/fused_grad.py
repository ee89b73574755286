"""Distance + input gradient, and the whole projection step, in one CUDA
kernel each.

Ports of ``posendf_tpu/ops/fused_grad.py::_vag_kernel`` and
``::_proj_kernel`` (kernels ``posendf_value_and_grad`` and
``posendf_project_step`` in ``csrc/field_kernels.cu``). Both run the field's
forward and its input-only backward for a tile of poses in one program:

  DFNet:    z_l = x_l W_l + b_l,  x_{l+1} = act(z_l),  d = out_act(z_{L-1})
            g_{L-1} = out_act'(z_{L-1});  g_l = (g_{l+1} W_{l+1}^T) act'(z_l)
  Encoder (reverse joint walk, j = J-1 .. 0):
            gf = gfeat[j] act'(f_pre[j]);  gh = (W2[j]^T gf) act'(h_pre[j])
            gq[j] = W1a[j]^T gh;  gfeat[p(j)] += W1b[j]^T gh   (non-roots)
  Input normalization x = q / n, n = sqrt(max(sum_J q^2, eps^2)):
            g = gx / n - q [s >= eps^2] <gx, q>_J / n^3

The projection step then takes ``q <- q - step_scale d g`` with the optional
tangent projection and per-quaternion renormalization. Unlike the TPU
value-and-grad kernel, the CUDA one folds the normalization's VJP in.

A bf16 field (``FieldWeights.compute_dtype``) runs both kernels' bf16 route,
as the TPU kernels' ``compute_dtype="bfloat16"``: every product of the
forward and of the backward on operands rounded to bf16 (the weights, and
the cotangent at each product: ``g`` before each W^T, ``gf`` and ``gh`` in
the encoder's reverse walk), summed in fp32; the derivative state (act'
exact: a bit a unit for lrelu and relu, softplus's fp32 slope sigmoid(beta
z), made from the exp of its forward, in both routes), the normalization's
VJP and the update in fp32.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version (``fused_distance_and_grad_ref``, ``project_step_ref``) for
a CPU tensor. Outputs are values, not part of an autograd graph, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

from posendf_torch import _build
from posendf_torch.models.activations import act_grad, out_act_grad_from_value
from posendf_torch.ops import fused_model
from posendf_torch.ops.fused_model import (
    TILE_POSES, FieldWeights, LaunchPlan, aligned_contiguous, check_poses, common_args,
    field_forward_ref, operand, plan_launch, stream_handle,
)
from posendf_torch.quat import quat_normalize
from posendf_torch.utils.profiling import span

__all__ = [
    "fused_distance_and_grad", "fused_distance_and_grad_ref",
    "project_step", "project_step_ref", "fused_project",
    "VAG_LAUNCHES", "PROJ_LAUNCHES",
]

# launches of each kernel since its count was last set to 0
VAG_LAUNCHES = 0
PROJ_LAUNCHES = 0

_EPS2 = 1e-24   # eps**2 of the normalizations (eps = 1e-12)


def _field_fwd_bwd_ref(x: torch.Tensor, weights: FieldWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and input-only backward over pre-normalized poses, written out
    as the kernels compute them: returns d (B, 1) and dd/dx (B, J, 4). In
    bf16 both operands of every product are rounded to bf16."""
    name, beta = weights.activation, weights.beta
    c = operand(weights)
    d, (zh, zf, zs) = field_forward_ref(x, weights, keep=True)
    g = out_act_grad_from_value(name, beta, d)
    L = len(weights.layers)
    for l in range(L - 1, -1, -1):
        if l < L - 1:
            g = g * act_grad(name, beta, zs[l])
        g = torch.matmul(c(g), c(weights.layers[l][0]).t())
    B, J, F = x.shape[0], weights.num_joints, weights.feature_size
    gfeat = list(g.reshape(B, J, F).unbind(1))
    w1, w2 = c(weights.enc["w1"]), c(weights.enc["w2"])
    gx = [None] * J
    for j in range(J - 1, -1, -1):
        gf = gfeat[j] * act_grad(name, beta, zf[j])
        gh = torch.matmul(c(gf), w2[j].t()) * act_grad(name, beta, zh[j])
        gin = torch.matmul(c(gh), w1[j].t())                # (B, 4 + F)
        gx[j] = gin[:, :4]
        p = weights.parents[j]
        if p >= 0:
            gfeat[p] = gfeat[p] + gin[:, 4:]
    return d, torch.stack(gx, dim=1)


def fused_distance_and_grad_ref(quat: torch.Tensor,
                                weights: FieldWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the value-and-grad kernel:
    (B, J, 4) -> ((B, 1), (B, J, 4))."""
    s = torch.sum(quat * quat, dim=1, keepdim=True)         # (B, 1, 4)
    n = s.clamp_min(_EPS2).sqrt()
    d, gx = _field_fwd_bwd_ref(quat / n, weights)
    dot = torch.sum(gx * quat, dim=1, keepdim=True)
    scale = torch.where(s >= _EPS2, dot / (n * n * n), torch.zeros_like(dot))
    return d, gx / n - quat * scale


def project_step_ref(q: torch.Tensor, weights: FieldWeights, *, step_scale: float = 1.0,
                     tangent: bool = False,
                     renormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the projection-step kernel:
    q (B, J, 4) -> (d (B, 1), q_next (B, J, 4))."""
    d, g = fused_distance_and_grad_ref(q, weights)
    if tangent:
        g = g - torch.sum(g * q, dim=-1, keepdim=True) * q
    q_next = q - step_scale * d[:, :, None] * g
    if renormalize:
        q_next = quat_normalize(q_next)
    return d, q_next


def _zscratch(quat: torch.Tensor, weights: FieldWeights, plan: LaunchPlan) -> torch.Tensor:
    """The derivative state the kernels keep for their backward, as many
    floats as the library says a launch of the plan's CTAs needs (each CTA
    of a split tile keeps its own): a bit a unit and pose for lrelu and relu
    (act' takes two values), the fp32 slope act'(z) = sigmoid(beta z) a unit
    and pose for softplus (``fused_model.state_kind``); the TPU kernels'
    ``_act_store`` keeps a bit or the pre-activation."""
    n = _build.library().posendf_field_scratch_floats(
        TILE_POSES * plan.ctas, weights.num_joints, weights.feature_size,
        weights.tc_packed().zsum, _build.ACT_CODES[weights.activation])
    return torch.empty(n, dtype=torch.float32, device=quat.device)


def fused_distance_and_grad(quat: torch.Tensor,
                            weights: FieldWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, dd/dquat): (B, J, 4) -> ((B, 1), (B, J, 4)). The gradient is taken
    with respect to the raw pose, through the joint-axis normalization."""
    global VAG_LAUNCHES
    check_poses(quat, weights)
    if quat.device.type == "cpu":
        with torch.no_grad():
            return fused_distance_and_grad_ref(quat, weights)
    quat = aligned_contiguous(quat)
    d = torch.empty((quat.shape[0], 1), dtype=torch.float32, device=quat.device)
    g = torch.empty_like(quat)
    plan = plan_launch(quat, weights)
    scratch = _zscratch(quat, weights, plan)
    lib = _build.library()
    _build.check(lib.posendf_value_and_grad(
        *common_args(quat, weights, plan), d.data_ptr(), g.data_ptr(),
        scratch.data_ptr(), stream_handle(quat)), "posendf_value_and_grad")
    VAG_LAUNCHES += 1
    fused_model.SPLIT_LAUNCHES[plan.split] += 1
    fused_model.STATE_LAUNCHES[fused_model.state_kind(weights)] += 1
    return d, g


def _launch_project_step(q: torch.Tensor, weights: FieldWeights, plan: LaunchPlan,
                         d_out: torch.Tensor, q_out: torch.Tensor, scratch: torch.Tensor,
                         step_scale: float, tangent: bool, renormalize: bool) -> None:
    global PROJ_LAUNCHES
    lib = _build.library()
    _build.check(lib.posendf_project_step(
        *common_args(q, weights, plan), d_out.data_ptr(), q_out.data_ptr(),
        scratch.data_ptr(), float(step_scale), int(tangent), int(renormalize),
        stream_handle(q)), "posendf_project_step")
    PROJ_LAUNCHES += 1
    fused_model.SPLIT_LAUNCHES[plan.split] += 1
    fused_model.STATE_LAUNCHES[fused_model.state_kind(weights)] += 1


def project_step(q: torch.Tensor, weights: FieldWeights, *, step_scale: float = 1.0,
                 tangent: bool = False,
                 renormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One projection step: q (B, J, 4) -> (d (B, 1), q_next (B, J, 4))."""
    check_poses(q, weights)
    if q.device.type == "cpu":
        with torch.no_grad():
            return project_step_ref(q, weights, step_scale=step_scale, tangent=tangent,
                                    renormalize=renormalize)
    q = aligned_contiguous(q)
    d = torch.empty((q.shape[0], 1), dtype=torch.float32, device=q.device)
    q_next = torch.empty_like(q)
    plan = plan_launch(q, weights)
    _launch_project_step(q, weights, plan, d, q_next, _zscratch(q, weights, plan), step_scale,
                         tangent, renormalize)
    return d, q_next


def fused_project(poses: torch.Tensor, weights: FieldWeights, *, steps: int,
                  renormalize: bool = True, step_scale: float = 1.0,
                  tangent: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole projection, one kernel launch per step over two pose buffers
    used in turn. Returns (projected (B, J, 4), history (steps, B)), where
    history[i] is d before step i's update. Its two spans (``utils.profiling``):
    ``posendf.project.prepare`` (the checks, the copy, the launch plan and the
    scratch) and ``posendf.project.steps`` (the launches)."""
    cuda = poses.device.type == "cuda"
    with span("posendf.project.prepare"):
        check_poses(poses, weights)
        history = torch.empty((steps, poses.shape[0]), dtype=torch.float32, device=poses.device)
        if cuda:
            bufs = [poses.clone(memory_format=torch.contiguous_format)]   # a fresh, aligned copy
            bufs.append(torch.empty_like(bufs[0]))
            plan = plan_launch(poses, weights)
            scratch = _zscratch(poses, weights, plan)
    with span("posendf.project.steps"):
        if cuda:
            for i in range(steps):
                _launch_project_step(bufs[i % 2], weights, plan, history[i], bufs[(i + 1) % 2],
                                     scratch, step_scale, tangent, renormalize)
            return bufs[steps % 2], history
        q = poses
        with torch.no_grad():
            for i in range(steps):
                d, q = project_step_ref(q, weights, step_scale=step_scale, tangent=tangent,
                                        renormalize=renormalize)
                history[i] = d[:, 0]
        return q.clone() if steps == 0 else q, history
