"""Partial-observation completion: a sequence fitted under the field prior
when only part of the motion is reliable.

Mirror of ``posendf_tpu/experiments/partial.py`` (the reference's
``experiments/partial_observation.py``): the motion-denoising solve with its
own gentler schedule (temp 100 L (1+it), data 10 L / (1+it), pose_pr
100 L / (1+it), ``partial_observation.py:31-34``), 10 iterations x 10 steps,
the first ``max_frames`` frames (120, ``:116,129``), no ground-truth metric.
Three modes: ``anchor`` (the data term anchors only the observed joints),
``inpaint`` (the observed dofs frozen, only the occluded limb moves) and
``retrieval`` (:func:`complete_by_retrieval`: the occluded joints spliced in
from the poses of a corpus nearest in the visible joints, found by the kNN
kernel, ``ops/fused_knn.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from posendf_torch.experiments.denoise import MotionDenoiser, _load_pose_file
from posendf_torch.experiments.optim import AnnealSpec
from posendf_torch.smpl.lbs import SMPL_VERTEX_LANDMARKS

__all__ = ["PARTIAL_SPECS", "INPAINT_SPECS", "PartialCompleter", "observation_mask",
           "dof_mask", "retrieval_weights", "complete_by_retrieval", "run_cli"]

PARTIAL_SPECS = {
    "pose_pr": AnnealSpec(scale=100.0, power=1, anneal=-1.0),
    "temp": AnnealSpec(scale=100.0, power=1, anneal=+1.0),
    "data": AnnealSpec(scale=10.0, power=1, anneal=-1.0, active_after=0),
}

# Jtr rows 24..44 are smplx's vertex-picked landmarks (lbs.SMPL_VERTEX_LANDMARKS:
# 5 face, 6 feet, 10 finger tips); each is carried by one skeleton joint:
# the head (15), the feet (10, 11), the hands (22, 23)
_LANDMARK_CARRIER = (15,) * 5 + (10,) * 3 + (11,) * 3 + (22,) * 5 + (23,) * 5

# The inpaint schedule: with the observed dofs frozen (dof_mask) a data term
# would read only frozen dofs on a real SMPL tree, a constant of zero
# gradient, so it is left out (the solver weights only the keys present).
# The denoise prior form (self-weighted 1e7 L^2) pulls the unobserved limb
# onto the manifold and the temporal term keeps its motion smooth.
INPAINT_SPECS = {
    "pose_pr": AnnealSpec(scale=1e7, power=2, anneal=-1.0),
    "temp": AnnealSpec(scale=10.0, power=1, anneal=+1.0),
}

# precision names of the JAX search -> the kNN kernel's engine: "highest" is
# the exact engine, "default" and "high" the bf16 operands of one bf16 pass
_ENGINE = {"highest": "vpu", "high": "mxu_bf16", "default": "mxu_bf16"}


def dof_mask(occluded_joints, num_dofs: int = 69) -> np.ndarray:
    """(num_dofs,) float mask, 1.0 on the OCCLUDED body-pose joints'
    axis-angle dofs and 0.0 elsewhere: the ``param_mask`` of an inpaint
    solve (only the unobserved dofs move; the observed stay to the bit)."""
    m = np.zeros(num_dofs, np.float32)
    for j in occluded_joints:
        j = int(j)
        if not 0 <= 3 * j + 2 < num_dofs:
            raise ValueError(f"occluded joint {j} out of range for {num_dofs} dofs")
        m[3 * j: 3 * j + 3] = 1.0
    return m


def observation_mask(body_model, occluded_joints) -> np.ndarray:
    """Per-row observation mask over ``body_model``'s Jtr rows: the
    ``data_joint_mask`` of a partial-observation solve.

    ``occluded_joints``: BODY-POSE joint indices 0..20/22 (body joint i is
    skeleton joint i+1). A skeleton joint is masked out (0.0) when it or
    any kinematic ancestor is occluded (an unobserved shoulder makes every
    joint below it unreliable), and a vertex landmark with its carrier
    joint. Everything else is 1.0. The 21 landmark rows are there only when
    the mesh covers ``SMPL_VERTEX_LANDMARKS``, as ``with_landmarks`` decides.
    """
    parents = body_model.model.parents
    K = len(parents)
    occ_sk = {int(j) + 1 for j in occluded_joints}
    if not all(1 <= j < K for j in occ_sk):
        raise ValueError(f"occluded_joints must be body-pose joint indices in [0, {K - 2}], "
                         f"got {sorted(occluded_joints)}")
    masked = np.zeros(K, bool)
    for k in range(K):
        a = k
        while a != -1:
            if a in occ_sk:
                masked[k] = True
                break
            a = parents[a]
    mask = (~masked).astype(np.float32)
    if body_model.model.v_template.shape[0] > int(SMPL_VERTEX_LANDMARKS.max()):
        mask = np.concatenate([mask, mask[np.asarray(_LANDMARK_CARRIER, int)]])
    return mask


class PartialCompleter(MotionDenoiser):
    """The partial-observation solve of ``field`` on ``body_model``'s
    skeleton, with :data:`PARTIAL_SPECS` unless ``specs`` is given
    (:data:`INPAINT_SPECS` for the inpaint mode's measured schedule)."""

    def __init__(self, field, body_model, specs=None):
        super().__init__(field, body_model, specs=specs or PARTIAL_SPECS)

    def optimize(self, pose_body, gt_pose_body=None, iterations: int = 10,
                 steps_per_iter: int = 10, occluded_joints=None, mode: str = "anchor", **kw):
        """``occluded_joints``: body-pose joint indices known to be
        unobserved. ``mode="anchor"``: the data term anchors only the
        observed joints (:func:`observation_mask`) and every dof moves;
        ``mode="inpaint"``: the observed dofs are also frozen
        (:func:`dof_mask`), so only the unobserved limb is completed.
        ``occluded_joints=None`` keeps the reference's anchor-everything
        solve. ``gt_pose_body`` only adds metrics."""
        if mode not in ("anchor", "inpaint"):
            raise ValueError(f"mode must be 'anchor' or 'inpaint', got {mode!r}")
        if isinstance(gt_pose_body, int):
            # an older signature took iterations second
            raise TypeError(f"got int {gt_pose_body} for gt_pose_body: the 2nd parameter is the "
                            "optional ground-truth sequence; pass iterations/steps_per_iter as "
                            "keywords")
        if occluded_joints is not None:
            kw.setdefault("data_joint_mask", observation_mask(self.body_model, occluded_joints))
            if mode == "inpaint":
                kw.setdefault("param_mask", dof_mask(occluded_joints))
        elif mode == "inpaint":
            raise ValueError("mode='inpaint' requires occluded_joints")
        return super().optimize(pose_body, gt_pose_body, iterations, steps_per_iter, **kw)


def _aligned_quat_mean(q: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Sign-align ``q`` (..., M, J, 4) to ``ref`` (..., 1, J, 4) (q and -q
    are one rotation), mean over axis -3, renormalize."""
    sgn = np.sign(np.sum(q * ref, axis=-1, keepdims=True))
    sgn = np.where(sgn == 0, 1.0, sgn)
    m = (q * sgn).mean(axis=-3)
    return m / np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12)


def retrieval_weights(occluded_joints, num_joints: int = 21):
    """(weights (J,), the occluded joints sorted) of a retrieval search: 1
    on the visible joints and 0 on the occluded, divided by their norm (so
    they do not sum to 1). The occluded set must be a proper nonempty
    subset of the joints."""
    occ = np.asarray(sorted({int(j) for j in occluded_joints}), int)
    if not (0 < len(occ) < num_joints) or occ.min() < 0 or occ.max() >= num_joints:
        raise ValueError(f"occluded_joints must be a proper nonempty subset of "
                         f"range({num_joints}), got {occ.tolist()}")
    w = np.ones(num_joints, np.float32)
    w[occ] = 0.0
    w /= np.linalg.norm(w)
    return w, occ


def complete_by_retrieval(corpus, quats, occluded_joints, *, k: int = 5,
                          temporal_window: int = 5, precision: str = "highest",
                          device="cuda") -> np.ndarray:
    """Retrieval-based limb completion of a (T, 21, 4) quaternion sequence
    against an (N, 21, 4) corpus of manifold poses (numpy or a tensor).

    For each frame the ``k`` corpus poses nearest in the VISIBLE joints
    (the joint-weighted geodesic top-k of ``ops/fused_knn.py``, the occluded
    joints' weights 0; ``precision`` "highest" the exact engine, "default"
    or "high" the bf16 one) are found on ``device`` (the card unless the
    caller asks for the CPU, where the kernel's plain version runs); the
    kernel keeps at most ``fused_knn.KMAX`` = 32 neighbours, so a larger
    ``k`` takes the streamed search of ``ops/knn.py`` at the same
    ``precision``, the counterpart of the XLA search the JAX package runs
    for every k. Their
    sign-aligned mean is spliced into the occluded joints, and the spliced
    joints are smoothed by a ``temporal_window``-frame quaternion moving
    average. The observed joints come back to the bit. Only the k
    neighbours of each frame leave the device.

    The field is measurably blind to structured per-limb corruption (its
    training noise perturbs all joints at once), so matching the visible
    joints against the corpus directly completes a limb where the prior's
    inpainting drifts (``docs/quality/partial_closed_loop.json``).
    """
    from posendf_torch.field import resolve_device
    from posendf_torch.ops.fused_knn import KMAX, fused_geodesic_topk
    from posendf_torch.ops.knn import geodesic_topk

    if temporal_window > 1 and temporal_window % 2 == 0:
        raise ValueError(f"temporal_window={temporal_window} must be odd (the smoothing window "
                         "is centered on each frame); an even value would average one frame "
                         "more than requested")
    if precision not in _ENGINE:
        raise ValueError(f"precision must be highest|high|default, got {precision!r}")
    dev = resolve_device(device)
    q_np = (quats.detach().cpu().numpy() if isinstance(quats, torch.Tensor)
            else np.asarray(quats)).astype(np.float32)
    J = q_np.shape[-2]
    w, occ = retrieval_weights(occluded_joints, J)
    corpus_t = torch.as_tensor(corpus).to(dev, torch.float32)
    q_t = torch.from_numpy(q_np).to(dev)
    if k <= KMAX:
        _, idx = fused_geodesic_topk(q_t, corpus_t, k, weights=w, dot_impl=_ENGINE[precision])
    else:
        _, idx = geodesic_topk(q_t, corpus_t, k, weights=torch.from_numpy(w).to(dev),
                               precision=precision)
    nn = corpus_t[idx].cpu().numpy()                  # (T, k, 21, 4)
    mean_q = _aligned_quat_mean(nn, nn[:, :1])        # (T, 21, 4)
    out = q_np.copy()
    out[:, occ] = mean_q[:, occ]
    if temporal_window > 1 and len(out) > 1:
        T = len(out)
        win = [np.clip(np.arange(T) + o, 0, T - 1)
               for o in range(-(temporal_window // 2), temporal_window // 2 + 1)]
        stack = np.stack([out[s][:, occ] for s in win], axis=1)
        out[:, occ] = _aligned_quat_mean(stack, out[:, None, occ])
    return out


def run_cli(args) -> None:
    """``cli partial``."""
    from posendf_torch.field import load_field
    from posendf_torch.quat import axis_angle_to_quaternion, quaternion_to_axis_angle
    from posendf_torch.smpl import BodyModel

    field = load_field(args.ckpt, config=args.config, device=args.device)
    bm = BodyModel(bm_path=args.bm_path, device=args.device)
    pose = _load_pose_file(args.motion_data)[: args.max_frames]
    occluded = args.occluded_joints
    metrics = {}
    if args.mode == "retrieval":
        if not args.corpus or not occluded:
            raise SystemExit("--mode retrieval requires --corpus and --occluded-joints")
        with np.load(args.corpus) as z:
            corpus = np.asarray(z["pose"], np.float32).reshape(-1, 21, 4)
        T = len(pose)
        quats = axis_angle_to_quaternion(torch.from_numpy(pose[:, :63]).reshape(T, 21, 3))
        done = complete_by_retrieval(corpus, quats, occluded, k=args.retrieval_k,
                                     temporal_window=args.temporal_window, device=args.device)
        out63 = quaternion_to_axis_angle(torch.from_numpy(done)).reshape(T, 63).numpy()
        final_pose = np.concatenate([out63, pose[:, 63:]], axis=1)
    else:
        specs = INPAINT_SPECS if args.mode == "inpaint" else None
        completer = PartialCompleter(field, bm, specs=specs)
        final_pose, metrics = completer.optimize(pose, occluded_joints=occluded, mode=args.mode)
        final_pose = final_pose.cpu().numpy()
    for k, v in metrics.items():
        print(f"{k}: {v:0.8f}")
    if args.out:
        np.savez(args.out, pose_body=final_pose)
        print(f"wrote {args.out}")
    if args.save_mesh or args.render:
        # before/after meshes, as the reference's partial task writes them
        # (exp_utils.py:30-63)
        from posendf_torch.experiments.render import export_pose_meshes

        out_dir = args.mesh_dir or "./partial_out"
        export_pose_meshes(out_dir, bm, [("init", pose), ("out", final_pose)],
                           save_mesh=args.save_mesh, render=args.render)
        print(f"wrote meshes/renders -> {out_dir}")
