"""Motion denoising: a noisy SMPL pose sequence optimized under the field prior.

Mirror of ``posendf_tpu/experiments/denoise.py`` (the reference's
``MotionDenoise``, ``experiments/motion_denoise.py:20-121``):

  * body_pose (T frames x 69) optimized by Adam(0.02), 10 iterations x 50
    steps (``optim.make_annealed_solver``);
  * losses: ``pose_pr`` (mean field distance of the 21 body joints'
    quaternions), ``temp`` (mean adjacent-frame vertex displacement), ``data``
    (mean joint distance to the input's joints, active after iteration 0);
  * the annealed self-weighted schedule (``motion_denoise.py:31-34``):
    temp 10 L (1+it), data 100 L / (1+it), pose_pr 1e7 L^2 / (1+it); a
    gentler fixed one (``"balanced"``) and a per-clip one scaled by the
    field's own noise estimate (``"adaptive"``);
  * metric: v2v error against the ground truth in cm (``:114-120``).

The field runs on its module path (``PoseNDF.forward``: the structure
encoder's kernel when the module was built with ``use_fused``, the DFNet
through ``torch.matmul``). ``optimize_many`` solves a stack of same-length
clips as one batch: the clips share no parameter, and the solve descends
the sum of each clip's weighted total (its own runtime scale, anneal and
step size), so it equals the clips' serial solves up to the order of float
sums.

Frame-sharded solves (``optimize(mesh=...)``, a
:class:`~posendf_torch.parallel.Mesh`): each rank holds T / size contiguous
frames of the pose, the betas and the input's joints (T must divide). Every
mean over frames is this rank's mean times its share of the count, summed
over the ranks by one all-reduce a term (``parallel.sum_across``, which
autograd passes through); the temporal term takes its one neighbour frame
through ``parallel/halo.py``. The annealed Adam is elementwise and stays on
each rank's frames. What is computed on the whole clip before the solve
(the input's body model output, the adaptive noise statistics) is computed
on the whole clip by every rank; the metrics are all-reduced and the pose is
gathered back in frame order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from posendf_torch.experiments.optim import AnnealSpec, make_annealed_solver
from posendf_torch.field import Field
from posendf_torch.parallel.halo import adjacent_difference_sharded
from posendf_torch.parallel.mesh import gather_rows, shard_rows, sum_across
from posendf_torch.projection import project
from posendf_torch.quat import axis_angle_to_quaternion, quaternion_to_axis_angle
from posendf_torch.smpl.lbs import lbs_forward, with_landmarks

__all__ = ["MotionDenoiser", "DENOISE_SPECS", "BALANCED_SPECS", "ADAPTIVE_SPECS",
           "estimate_clip_noise", "estimate_clip_noise_many", "adaptive_runtime",
           "v2v_cm", "run_cli"]

DENOISE_SPECS = {
    "pose_pr": AnnealSpec(scale=1e7, power=2, anneal=-1.0),
    "temp": AnnealSpec(scale=10.0, power=1, anneal=+1.0),
    "data": AnnealSpec(scale=100.0, power=1, anneal=-1.0, active_after=0),
}

# For inputs whose noise sits near or below the field's resolution: a 1000x
# weaker prior peak, a 10x weaker temporal term, the data term active from
# iteration 0 (`cli denoise --specs balanced`).
BALANCED_SPECS = {
    "pose_pr": AnnealSpec(scale=1e4, power=2, anneal=-1.0),
    "temp": AnnealSpec(scale=1.0, power=1, anneal=+1.0),
    "data": AnnealSpec(scale=100.0, power=1, anneal=-1.0),
}

# The field-adaptive schedule (`--specs adaptive`): these static fields are
# the s = 1 endpoint (the reference schedule); per clip, the runtime overrides
# of ``adaptive_runtime`` move scale, anneal and gating toward an
# input-anchored s = 0 endpoint as a function of ``estimate_clip_noise``.
ADAPTIVE_SPECS = {
    "pose_pr": AnnealSpec(scale=1e7, power=2, anneal=-1.0),
    "temp": AnnealSpec(scale=10.0, power=1, anneal=+1.0),
    "data": AnnealSpec(scale=100.0, power=1, anneal=-1.0, active_after=0),
}


def _f32(x: float) -> float:
    return float(np.float32(x))


def adaptive_runtime(s: float, prior_gain: float = 1.0) -> dict:
    """The runtime overrides (``aux["anneal_runtime"]``) of a clip-level
    noise estimate ``s`` in [0, 1]; s = 1 is the reference schedule, s = 0
    the near-clean endpoint (log-space in between):

      pose_pr scale: 10^(4 + 3s)   (1e4 .. 1e7), times ``prior_gain``
      temp    scale: 10^(2s - 1)   (0.1 .. 10)
      data   anneal: -s            (constant .. 1/(1+it) decay)
      data     gate: active when it > s - 1  (always .. after iteration 0)

    The values are float32-rounded, as the JAX package's are.
    """
    s = float(np.clip(s, 0.0, 1.0))
    return {
        "pose_pr": {"scale": _f32(prior_gain * 10.0 ** (4.0 + 3.0 * s))},
        "temp": {"scale": _f32(10.0 ** (2.0 * s - 1.0))},
        "data": {"anneal": _f32(-s), "active_after": _f32(s - 1.0)},
    }


def _lr_runtime(s: float) -> float:
    """The step-size factor 10^(2(s-1)) (0.01 .. 1) of an adaptive solve:
    Adam's late-step oscillation is set by the learning rate, not the
    weights, so a near-clean clip needs smaller updates."""
    return _f32(10.0 ** (2.0 * (float(np.clip(s, 0.0, 1.0)) - 1.0)))


def _noise_stats(field: Field, quats: torch.Tensor, probe_noise: torch.Tensor,
                 floor_steps: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each clip's (d_input, d_floor, d_probe), (C,) each, of a (C, T, J, 4)
    stack: the mean field distance of the input, of the input projected
    ``floor_steps`` steps, and of the input plus ``probe_noise`` (broadcast
    to the stack), renormalized."""
    module = field.module
    C, T, J = quats.shape[:3]
    flat = quats.reshape(C * T, J, 4)
    proj, _ = project(field, flat, steps=floor_steps)
    with torch.no_grad():
        d_input = module(flat).reshape(C, T).mean(1)
        d_floor = module(proj).reshape(C, T).mean(1)
        probe = quats + probe_noise
        probe = probe / torch.linalg.norm(probe, dim=-1, keepdim=True)
        d_probe = module(probe.reshape(C * T, J, 4)).reshape(C, T).mean(1)
    return d_input, d_floor, d_probe


def _estimates(field: Field, quats: torch.Tensor, probe_noise, generator, sigma_ref: float,
               sigma_ref_temporal: float, floor_steps: int) -> list:
    """``estimate_clip_noise`` of each clip of a (C, T, J, 4) stack, one
    probe-noise draw (T, J, 4) shared by every clip."""
    C, T = quats.shape[:2]
    if probe_noise is None:
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        probe_noise = sigma_ref * torch.rand(quats.shape[1:], generator=gen,
                                             device=gen.device)
    probe_noise = torch.as_tensor(probe_noise, dtype=quats.dtype).to(quats.device)
    stats = torch.stack(_noise_stats(field, quats, probe_noise, floor_steps), 1)
    stats = stats.double().cpu().numpy()
    aa = quaternion_to_axis_angle(quats).reshape(C, T, -1).detach().cpu().numpy()
    out = []
    for c in range(C):
        d_input, d_floor, d_probe = (float(x) for x in stats[c])
        span = d_probe - d_floor
        s_field = float(np.clip((d_input - d_floor) / span if span > 1e-12 else 0.0, 0.0, 1.0))
        s_temporal = 0.0
        if T >= 3:
            d1 = float(np.mean((aa[c, 1:] - aa[c, :-1]) ** 2))
            d2 = float(np.mean((aa[c, 2:] - aa[c, :-2]) ** 2))
            n2 = max((4.0 * d1 - d2) / 6.0, 0.0)
            s_temporal = float(np.clip(np.sqrt(n2) / sigma_ref_temporal, 0.0, 1.0))
        out.append({"s": max(s_field, s_temporal), "s_field": s_field,
                    "s_temporal": s_temporal, "d_input": d_input, "d_floor": d_floor,
                    "d_probe": d_probe})
    return out


def estimate_clip_noise(field: Field, quats, generator: Optional[torch.Generator] = None, *,
                        probe_noise=None, sigma_ref: float = 0.1,
                        sigma_ref_temporal: float = 0.2, floor_steps: int = 10) -> dict:
    """A clip's noise level, with no ground truth: ``s = max(s_field,
    s_temporal)``.

    Field sensor: ``s_field = clip((d_input - d_floor) / (d_probe -
    d_floor), 0, 1)`` (0 for a degenerate field) of three statistics: the
    mean field distance of the input (d_input), of the input projected onto
    the manifold (d_floor, the field's own floor there) and of the input
    re-noised at a reference level (d_probe: ``probe_noise`` added, by
    default ``sigma_ref`` times a uniform [0, 1) draw of the clip's shape
    from ``generator``, ``torch.Generator().manual_seed(0)`` if none; the
    JAX package draws it from ``jax.random.key(0)``, so the two packages'
    default probes differ).

    Temporal sensor: mocap noise is white per frame while motion is smooth,
    so for per-dof axis-angle differences d1 = E[(x[t+1]-x[t])^2] and
    d2 = E[(x[t+2]-x[t])^2], n^2 = (4 d1 - d2) / 6, and ``s_temporal =
    n / sigma_ref_temporal`` clipped (needs 3 frames; 0 otherwise).

    Returns ``{"s", "s_field", "s_temporal", "d_input", "d_floor", "d_probe"}``.
    """
    quats = torch.as_tensor(quats, dtype=torch.float32).to(field.device)
    quats = quats.reshape(-1, quats.shape[-2], 4)
    return _estimates(field, quats[None], probe_noise, generator, sigma_ref,
                      sigma_ref_temporal, floor_steps)[0]


def estimate_clip_noise_many(field: Field, quats, generator: Optional[torch.Generator] = None,
                             *, probe_noise=None, sigma_ref: float = 0.1,
                             sigma_ref_temporal: float = 0.2, floor_steps: int = 10) -> list:
    """:func:`estimate_clip_noise` of each clip of a (C, T, J, 4) stack, the
    field statistics of all clips in one batch and one probe draw (T, J, 4)
    for every clip, as a serial sweep draws it; a list of C dicts."""
    quats = torch.as_tensor(quats, dtype=torch.float32).to(field.device)
    return _estimates(field, quats, probe_noise, generator, sigma_ref, sigma_ref_temporal,
                      floor_steps)


def v2v_cm(verts_a: torch.Tensor, verts_b: torch.Tensor, axis=None):
    """Mean per-vertex distance in centimeters (``motion_denoise.py:119``): a
    float over everything, or with ``axis`` (e.g. ``(1, 2)`` of a (C, T, V,
    3) stack) an ndarray of the means over those axes."""
    d = torch.sqrt(torch.sum((verts_a - verts_b) ** 2, dim=-1))
    if axis is None:
        return float(torch.mean(d) * 100.0)
    return (torch.mean(d, dim=axis) * 100.0).cpu().numpy()


def _v2v_sharded(verts_a: torch.Tensor, verts_b: torch.Tensor, mesh) -> float:
    """:func:`v2v_cm` of two whole (T, V, 3) clips, each rank's frames'
    mean times its share, all-reduced (the unsharded value without a
    mesh, and to the bit with one rank)."""
    if mesh is None:
        return v2v_cm(verts_a, verts_b)
    T = verts_a.shape[0]
    rows = shard_rows(mesh, T, even=True)
    d = torch.sqrt(torch.sum((verts_a[rows] - verts_b[rows]) ** 2, dim=-1))
    return float(sum_across(mesh, torch.mean(d) * ((rows.stop - rows.start) / T)) * 100.0)


class MotionDenoiser:
    """Denoises pose sequences under ``field``'s prior with ``body_model``
    (both on one device).

    ``field``: a :class:`~posendf_torch.field.Field` or a ``PoseNDF``
    module. ``specs``: a spec dict (default the reference-exact
    ``DENOISE_SPECS``), or one of the names ``"reference"``, ``"balanced"``
    and ``"adaptive"`` (the per-clip schedule of ``estimate_clip_noise``
    and ``adaptive_runtime``). ``prior_gain`` multiplies the adaptive prior
    weight only (0.0: the prior-off ablation of the same schedule).
    """

    def __init__(self, field, body_model, specs=None, prior_gain: float = 1.0):
        self.field = field if isinstance(field, Field) else Field(field)
        self.body_model = body_model
        if body_model.device != self.field.device:
            raise ValueError(f"the field is on {self.field.device} but the body model "
                             f"on {body_model.device}")
        self.adaptive = specs == "adaptive"
        if isinstance(specs, str):
            named = {"adaptive": dict(ADAPTIVE_SPECS), "balanced": dict(BALANCED_SPECS),
                     "reference": dict(DENOISE_SPECS)}
            if specs not in named:
                raise ValueError(f"unknown specs name {specs!r}; expected one of "
                                 f"{sorted(named)} or a spec dict")
            self.specs = named[specs]
        else:
            self.specs = specs or DENOISE_SPECS
        self.prior_gain = prior_gain

    @property
    def device(self) -> torch.device:
        return self.field.device

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _loss_terms(self, pose: torch.Tensor, aux: dict) -> Dict[str, torch.Tensor]:
        """The three terms of each clip of a (C, T, 69) pose stack, (C,) each.

        Under ``aux["mesh"]`` the stack holds this rank's t of the clip's
        ``aux["frames"]`` frames: each term is this rank's mean times its
        share of the count (the temporal one its differences' share),
        summed over the ranks by one all-reduce. Without a mesh every share
        is 1 and the sum is the identity."""
        mesh = aux.get("mesh")
        C, t = pose.shape[:2]
        T = aux.get("frames", t)
        flat = pose.reshape(C * t, 69)
        quat = axis_angle_to_quaternion(flat.reshape(C * t, 23, 3)[:, :21])
        dist = self.field.module(quat).reshape(C, t)
        verts, joints = lbs_forward(self.body_model.model, aux["betas"],
                                    flat.new_zeros((C * t, 3)), flat)
        # the full smplx Jtr (45 joints on a real mesh), as the input's joints
        # were taken and as the reference's data term reads it (motion_denoise.py:93)
        joints = with_landmarks(verts, joints)
        verts = verts.reshape(C, t, *verts.shape[1:])
        joints = joints.reshape(C, t, *joints.shape[1:])
        if T > 1:
            # (C, t', V), t' = t or (on the last rank) t - 1
            d = adjacent_difference_sharded(verts, mesh, dim=1)
            temp = torch.sqrt(torch.sum(d ** 2, dim=-1) + 1e-12)
            # a last rank of one frame has no difference of its own; its sum
            # of none still carries the halo's backward, which every rank runs
            temp = (temp.mean((1, 2)) * (d.shape[1] / (T - 1)) if d.shape[1]
                    else temp.sum((1, 2)))
        else:
            # a single frame has no temporal stencil (the mean of none is NaN)
            temp = flat.new_zeros((C,))
        diff = torch.sqrt(torch.sum((joints - aux["init_joints"]) ** 2, dim=-1) + 1e-12)
        if "data_joint_mask" in aux:
            # partial observation: anchor only the observed joints (a mask over Jtr rows)
            m = aux["data_joint_mask"]
            data = torch.sum(diff * m, dim=(1, 2)) / (T * torch.clamp_min(torch.sum(m), 1e-9))
        else:
            data = diff.mean((1, 2)) * (t / T)
        terms = sum_across(mesh, torch.stack([dist.mean(1) * (t / T), temp, data], 1))
        return {"pose_pr": terms[:, 0], "temp": terms[:, 1], "data": terms[:, 2]}

    def _solve(self, pose0: torch.Tensor, aux: dict, iterations: int, steps_per_iter: int):
        solve = make_annealed_solver(self._loss_terms, self.specs, iterations=iterations,
                                     steps_per_iter=steps_per_iter, lr=0.02)
        return solve(pose0, aux)

    def optimize(self, noisy_pose_body, gt_pose_body=None, iterations: int = 10,
                 steps_per_iter: int = 50, betas=None, mesh=None, mesh_axis: str = "data",
                 data_joint_mask=None, param_mask=None) -> Tuple[torch.Tensor, Dict[str, float]]:
        """(denoised pose_body (T, 69), metrics) of a (T, 69) or (T, 63)
        axis-angle clip.

        ``data_joint_mask``: a float mask over the body model's Jtr rows; the
        data term anchors only the joints masked in. ``param_mask``: a float
        mask broadcastable to the (T, 69) pose; the dofs masked out stay at
        their input values, to the bit.

        ``mesh``: the frames are split over the mesh's ranks (T must divide;
        every rank passes the whole clip and gets the whole result; see the
        module docstring). ``mesh_axis`` names the mesh's axis, as in the
        JAX package.
        """
        if mesh is not None and mesh.axis != mesh_axis:
            raise ValueError(f"mesh axis {mesh.axis!r} is not mesh_axis {mesh_axis!r}")
        noisy = self._tensor(noisy_pose_body)
        if gt_pose_body is not None and len(gt_pose_body) != len(noisy):
            raise ValueError(
                f"gt sequence has {len(gt_pose_body)} frames but the noisy input "
                f"has {len(noisy)}; align them before optimizing")
        with torch.no_grad():
            init_out = self.body_model(pose_body=noisy, betas=betas)
        pose0 = init_out.body_pose
        T = pose0.shape[0]
        aux = {"betas": init_out.betas, "init_joints": init_out.Jtr[None]}
        if mesh is not None:
            rows = shard_rows(mesh, T, even=True)
            betas_rows = init_out.betas[rows] if init_out.betas.shape[0] == T else init_out.betas
            aux = {"betas": betas_rows, "init_joints": init_out.Jtr[None, rows], "mesh": mesh,
                   "frames": T}
        if data_joint_mask is not None:
            mask = self._tensor(data_joint_mask)
            if mask.shape != init_out.Jtr.shape[1:2]:
                raise ValueError(
                    f"data_joint_mask has shape {tuple(mask.shape)}; expected "
                    f"({init_out.Jtr.shape[1]},) to match this body model's Jtr rows")
            aux["data_joint_mask"] = mask
        if param_mask is not None:
            mask = self._tensor(param_mask)
            try:
                aux["param_mask"] = torch.broadcast_to(mask, pose0.shape)[None]
                if mesh is not None:
                    aux["param_mask"] = aux["param_mask"][:, rows]
            except RuntimeError:
                raise ValueError(
                    f"param_mask has shape {tuple(mask.shape)}; expected a shape "
                    f"broadcastable to the optimized pose {tuple(pose0.shape)} "
                    f"(e.g. ({pose0.shape[-1]},))") from None
        noise_est = None
        if self.adaptive:
            in_quats = axis_angle_to_quaternion(noisy[:, :63].reshape(T, 21, 3))
            noise_est = estimate_clip_noise(self.field, in_quats)
            aux["anneal_runtime"] = adaptive_runtime(noise_est["s"], self.prior_gain)
            aux["lr_runtime"] = _lr_runtime(noise_est["s"])
        if mesh is None:
            final, history = self._solve(pose0[None], aux, iterations, steps_per_iter)
            final_pose = final[0]
        else:
            final, history = self._solve(pose0[None, rows], aux, iterations, steps_per_iter)
            final_pose = gather_rows(mesh, final[0])

        with torch.no_grad():
            out = self.body_model(pose_body=final_pose, betas=betas)
            metrics = {
                "v2v_vs_input_cm": _v2v_sharded(out.vertices, init_out.vertices, mesh),
                "final_pose_pr": float(history["pose_pr"][-1, 0]),
                "final_temp": float(history["temp"][-1, 0]),
            }
            if noise_est is not None:
                metrics["noise_level_s"] = noise_est["s"]
                metrics["noise_d_input"] = noise_est["d_input"]
                metrics["noise_d_floor"] = noise_est["d_floor"]
                metrics["noise_d_probe"] = noise_est["d_probe"]
            if gt_pose_body is not None:
                gt_out = self.body_model(pose_body=gt_pose_body, betas=betas)
                metrics["v2v_cm"] = _v2v_sharded(out.vertices, gt_out.vertices, mesh)
                # the number denoising must beat: the raw input's error
                metrics["v2v_input_cm"] = _v2v_sharded(init_out.vertices, gt_out.vertices, mesh)
        return final_pose, metrics

    def optimize_many(self, noisy_pose_body, gt_pose_body=None, iterations: int = 10,
                      steps_per_iter: int = 50, betas=None,
                      data_joint_mask=None) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
        """:meth:`optimize` of C same-length clips, (C, T, 69|63), as one
        batched solve; metrics as (C,) arrays. The adaptive schedule stays
        per clip. ``betas``: None, one shared (num_betas,) vector or per-frame
        (C*T, num_betas)."""
        noisy = self._tensor(noisy_pose_body)
        if noisy.dim() != 3:
            raise ValueError(f"optimize_many expects (clips, frames, dofs), got "
                             f"{tuple(noisy.shape)}")
        C, T = noisy.shape[:2]
        gt = None
        if gt_pose_body is not None:
            gt = self._tensor(gt_pose_body)
            if tuple(gt.shape[:2]) != (C, T):
                raise ValueError(f"gt stack {tuple(gt.shape[:2])} does not match the noisy "
                                 f"stack {(C, T)}")
        if betas is not None:
            b = self._tensor(betas)
            b = b[None] if b.dim() == 1 else b
            if b.shape[0] not in (1, C * T):
                raise ValueError(f"betas must be None, (num_betas,), or per-frame "
                                 f"({C * T}, num_betas); got {tuple(b.shape)}")
            betas = b
        with torch.no_grad():
            init_out = self.body_model(pose_body=noisy.reshape(C * T, -1), betas=betas)
        pose0 = init_out.body_pose.reshape(C, T, 69)
        init_verts = init_out.vertices.reshape(C, T, *init_out.vertices.shape[1:])
        aux = {"betas": init_out.betas,
               "init_joints": init_out.Jtr.reshape(C, T, *init_out.Jtr.shape[1:])}
        if data_joint_mask is not None:
            mask = self._tensor(data_joint_mask)
            if mask.shape != init_out.Jtr.shape[1:2]:
                raise ValueError(f"data_joint_mask has shape {tuple(mask.shape)}; expected "
                                 f"({init_out.Jtr.shape[1]},)")
            aux["data_joint_mask"] = mask
        noise_s = None
        if self.adaptive:
            in_quats = axis_angle_to_quaternion(noisy[:, :, :63].reshape(C, T, 21, 3))
            ests = estimate_clip_noise_many(self.field, in_quats)
            runtimes = [adaptive_runtime(e["s"], self.prior_gain) for e in ests]
            aux["anneal_runtime"] = {
                term: {k: self._tensor([r[term][k] for r in runtimes]) for k in vals}
                for term, vals in runtimes[0].items()}
            aux["lr_runtime"] = self._tensor([_lr_runtime(e["s"]) for e in ests]).reshape(C, 1, 1)
            noise_s = np.asarray([e["s"] for e in ests])
        final_pose, history = self._solve(pose0, aux, iterations, steps_per_iter)

        with torch.no_grad():
            out = self.body_model(pose_body=final_pose.reshape(C * T, 69), betas=betas)
            out_verts = out.vertices.reshape(C, T, *out.vertices.shape[1:])
            metrics: Dict[str, np.ndarray] = {
                "v2v_vs_input_cm": v2v_cm(out_verts, init_verts, axis=(1, 2)),
                "final_pose_pr": history["pose_pr"][-1].cpu().numpy(),
                "final_temp": history["temp"][-1].cpu().numpy(),
            }
            if noise_s is not None:
                metrics["noise_level_s"] = noise_s
            if gt is not None:
                gt_out = self.body_model(pose_body=gt.reshape(C * T, -1), betas=betas)
                gt_verts = gt_out.vertices.reshape(C, T, *gt_out.vertices.shape[1:])
                metrics["v2v_cm"] = v2v_cm(out_verts, gt_verts, axis=(1, 2))
                metrics["v2v_input_cm"] = v2v_cm(init_verts, gt_verts, axis=(1, 2))
        return final_pose, metrics


def _load_pose_file(path: str, frames: Optional[int] = None) -> np.ndarray:
    """A pose sequence (key ``pose_body`` or ``pose``) zero-padded to (T, 69);
    ``frames`` keeps the first ``frames`` rows."""
    with np.load(path) as z:
        key = "pose_body" if "pose_body" in z else "pose"
        pb = np.asarray(z[key]).astype(np.float32)
    out = np.zeros((len(pb), 69), np.float32)
    out[:, : min(pb.shape[1], 69)] = pb[:, :69]
    return out[:frames] if frames else out


def run_cli(args) -> None:
    """``cli denoise``."""
    from posendf_torch.field import load_field
    from posendf_torch.smpl import BodyModel

    field = load_field(args.ckpt, config=args.config, device=args.device)
    bm = BodyModel(bm_path=args.bm_path, device=args.device)
    noisy = _load_pose_file(args.motion_data)
    # align gt to the noisy clip up front: a frame-count mismatch would
    # otherwise surface only after the full solve
    gt = _load_pose_file(args.gt_data, frames=len(noisy)) if args.gt_data else None
    if gt is not None and len(gt) < len(noisy):
        noisy = noisy[: len(gt)]
    specs = {"balanced": BALANCED_SPECS, "adaptive": "adaptive"}.get(args.specs)
    denoiser = MotionDenoiser(field, bm, specs=specs)
    final_pose, metrics = denoiser.optimize(noisy, gt, iterations=args.iterations,
                                            steps_per_iter=args.steps_per_iter)
    for k, v in metrics.items():
        print(f"{k}: {v:0.8f}")
    if args.out:
        np.savez(args.out, pose_body=final_pose.cpu().numpy(), **metrics)
        print(f"wrote {args.out}")
    if args.save_mesh or args.render:
        # before/after meshes, as the reference denoiser writes them
        # (motion_denoise.py:61,112 via exp_utils.py:30-63)
        from posendf_torch.experiments.render import export_pose_meshes

        out_dir = args.mesh_dir or "./denoised"
        export_pose_meshes(out_dir, bm, [("init", noisy), ("out", final_pose)],
                           save_mesh=args.save_mesh, render=args.render)
        print(f"wrote meshes/renders -> {out_dir}")
