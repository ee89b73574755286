"""Image-based 3D pose estimation: SMPLify-style fitting with the field prior.

Mirror of ``posendf_tpu/experiments/fit_image.py`` (the reference's
``ImageFit``, ``experiments/image_fitting.py:21-243``, its intended
three-stage behaviour):

  stage 1, camera init (``:110-137``): the camera's rotation (axis-angle,
    mapped through ``axis_angle_to_matrix`` so it stays a rotation; set
    ``optimize_camera_rotation=False`` for the fixed identity) and
    translation and the body's global orientation against the torso
    keypoints (OpenPose RHip, LHip, RShoulder, LShoulder), with a depth
    term toward ``trans_estimation`` (10, ``:32``);
  stage 2, full body (``:139-168``): pose, orientation and betas under the
    confidence-weighted 2D reprojection error and the pose prior;
  stage 3, refinement (``:183-213``): the denoising schedule, the prior and
    a data term toward the stage-2 joints.

Keypoints are OpenPose BODY_25 (x, y, confidence), as the reference reads
them from ``kpts.npz`` (``:239``); SMPL joints map to them through
``SMPL_TO_OPENPOSE`` (24 joints) or ``SMPLX45_TO_OPENPOSE`` (a real mesh's
45 Jtr rows); unmapped keypoints weigh 0. Each stage is one annealed-Adam
solve (``experiments/optim.py``) of a dict of parameters. The prior is the
field's module path (``PoseNDF.forward``: the structure encoder's kernel
when the module was built with ``use_fused``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from posendf_torch.experiments.camera import init_camera, project_points
from posendf_torch.experiments.optim import AnnealSpec, make_annealed_solver
from posendf_torch.field import Field
from posendf_torch.quat import axis_angle_to_matrix, axis_angle_to_quaternion
from posendf_torch.smpl.lbs import SMPL_VERTEX_LANDMARKS, lbs_forward, with_landmarks

__all__ = ["ImageFitter", "SMPL_TO_OPENPOSE", "SMPLX45_TO_OPENPOSE", "TORSO_OPENPOSE_IDXS",
           "STAGE1_SPECS", "STAGE2_SPECS", "STAGE3_SPECS", "SELF_WEIGHTED_PRIOR",
           "project_result_keypoints", "save_keypoint_overlay", "run_cli"]

# OpenPose BODY_25 index -> SMPL joint index (-1: no SMPL joint; the eyes,
# ears and feet tips are mesh vertices, outside the 24-joint skeleton)
SMPL_TO_OPENPOSE = np.array([
    15,  # 0  nose ~ head
    12,  # 1  neck
    17,  # 2  RShoulder
    19,  # 3  RElbow
    21,  # 4  RWrist
    16,  # 5  LShoulder
    18,  # 6  LElbow
    20,  # 7  LWrist
    0,   # 8  MidHip ~ pelvis
    2,   # 9  RHip
    5,   # 10 RKnee
    8,   # 11 RAnkle
    1,   # 12 LHip
    4,   # 13 LKnee
    7,   # 14 LAnkle
    -1, -1, -1, -1,  # 15-18 eyes/ears
    -1, -1, -1, -1, -1, -1,  # 19-24 feet
])

# 45 Jtr rows (smplx's, with the landmarks of lbs.SMPL_VERTEX_LANDMARKS: 24
# nose, 25-28 R/L eye, R/L ear, 29-34 L/R BigToe SmallToe Heel) -> BODY_25.
# On a real SMPL mesh every keypoint has a counterpart, as the reference's
# projection of the full smplx joint set has (image_fitting.py:68,86).
SMPLX45_TO_OPENPOSE = np.array([
    24,  # 0  nose (landmark, not the head joint)
    12,  # 1  neck
    17, 19, 21,        # 2-4   R shoulder/elbow/wrist
    16, 18, 20,        # 5-7   L shoulder/elbow/wrist
    0,                 # 8     MidHip
    2, 5, 8,           # 9-11  R hip/knee/ankle
    1, 4, 7,           # 12-14 L hip/knee/ankle
    25, 26, 27, 28,    # 15-18 REye LEye REar LEar
    29, 30, 31,        # 19-21 LBigToe LSmallToe LHeel
    32, 33, 34,        # 22-24 RBigToe RSmallToe RHeel
])

TORSO_OPENPOSE_IDXS = (9, 12, 2, 5)  # the reference's init_joints_idxs (:30)

STAGE1_SPECS = {"data": AnnealSpec(scale=1.0), "depth": AnnealSpec(scale=100.0)}
STAGE2_SPECS = {"data": AnnealSpec(scale=1.0),
                "pose_pr": AnnealSpec(scale=100.0, power=1, anneal=-1.0)}
STAGE3_SPECS = {
    "pose_pr": AnnealSpec(scale=100.0, power=1, anneal=-1.0),
    "data": AnnealSpec(scale=10.0, power=1, anneal=-1.0, active_after=0),
}

# The reference weights the fit prior linearly (1e2 L / (1+it),
# image_fitting.py:40). On a trained ReLU-headed field the d = 0 set is a
# region, and from the zero-pose init inside it the linear penalty pins the
# solve there whatever the keypoints. ``prior_form='self'`` applies the
# denoise schedule's self-weighted form (1e7 L^2, motion_denoise.py:33),
# whose weight vanishes with the loss, to stages 2 and 3
# (scripts/fit_image_quality.py measures it); the default stays the reference's.
SELF_WEIGHTED_PRIOR = AnnealSpec(scale=1e7, power=2, anneal=-1.0)


@functools.lru_cache(maxsize=16)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """An index tensor on ``device``, made once: a host index would be
    copied to the card, and waited on, at every step of a solve."""
    return torch.tensor(values, dtype=torch.long, device=device)


def _center(center, B: int, device) -> torch.Tensor:
    """The (B, 2) principal point: ``center`` (2,) repeated, or zeros."""
    if center is None:
        return torch.zeros((B, 2), device=device)
    return torch.as_tensor(center, dtype=torch.float32, device=device).reshape(1, 2).repeat(B, 1)


class ImageFitter:
    """Fits SMPL bodies to OpenPose keypoints under ``field``'s prior, with
    ``body_model`` (both on one device).

    ``prior_scale`` multiplies the prior weight of stages 2 and 3 (0.0: the
    prior-off ablation of the same solve). ``prior_form``: 'reference', the
    linear 1e2 L / (1+it) (image_fitting.py:40), or 'self', the denoise
    schedule's self-weighted 1e7 L^2 / (1+it) (:data:`SELF_WEIGHTED_PRIOR`).
    """

    def __init__(self, field, body_model, trans_estimation: float = 10.0,
                 focal_length: float = 5000.0, optimize_camera_rotation: bool = True,
                 prior_scale: float = 1.0, prior_form: str = "reference"):
        if prior_form not in ("reference", "self"):
            raise ValueError(f"prior_form must be 'reference' or 'self', got {prior_form!r}")
        self.field = field if isinstance(field, Field) else Field(field)
        self.body_model = body_model
        if body_model.device != self.field.device:
            raise ValueError(f"the field is on {self.field.device} but the body model on "
                             f"{body_model.device}")
        self.trans_estimation = trans_estimation
        self.focal_length = focal_length
        self.optimize_camera_rotation = optimize_camera_rotation
        self.prior_scale = prior_scale
        self.prior_form = prior_form
        # the stage solvers by (batch, iterations, steps_per_iter), as JAX
        # caches its compiled solves; each image's data comes through aux
        self._solvers = {}

    @property
    def device(self) -> torch.device:
        return self.field.device

    def _mapped_joints(self, joints: torch.Tensor) -> torch.Tensor:
        """(B, 24|45, 3) joints -> (B, 25, 3) in OpenPose order. With the
        45-row landmark set every slot is real; on a 24-joint mesh the eye,
        ear and feet slots take joint 0, and weigh 0."""
        table = SMPLX45_TO_OPENPOSE if joints.shape[1] >= 45 else SMPL_TO_OPENPOSE
        gather = tuple(int(j) for j in np.where(table >= 0, table, 0))
        return joints[:, _index(gather, joints.device), :]

    def _fk(self, betas, orient, pose):
        verts, joints = lbs_forward(self.body_model.model, betas, orient, pose)
        return verts, with_landmarks(verts, joints)

    def _prior(self, pose_body: torch.Tensor) -> torch.Tensor:
        B = pose_body.shape[0]
        quat = axis_angle_to_quaternion(pose_body.reshape(B, 23, 3)[:, :21])
        return torch.mean(self.field.module(quat))

    def _stage2_pose(self, B: int) -> torch.Tensor:
        """Stage 2's initial pose: a small fixed symmetry-breaking draw, 1e-2
        x N(0, 1) (B, 69) from a generator seeded 0 on the host (JAX draws
        it from ``jax.random.key(0)``, other numbers). Not exact zeros: the
        model's joint-axis normalize is directionally singular there (on the
        trained L8 field d jumps 0.008 -> 0.104 within 1e-3 of the zero pose
        and the prior's gradient is ~2e10, which poisons Adam's second
        moment for the whole solve)."""
        g = torch.Generator().manual_seed(0)
        return (1e-2 * torch.randn((B, 69), generator=g)).to(self.device)

    def _stage1_terms(self, p: dict, aux: dict) -> Dict[str, torch.Tensor]:
        """Stage 1: the torso keypoints' squared error (pixels^2, summed) and
        the depth term, of ``{translation, global_orient[, cam_rot]}``."""
        B = p["global_orient"].shape[0]
        z = p["global_orient"].new_zeros
        _, joints = self._fk(z((B, self.body_model.num_betas)), p["global_orient"], z((B, 69)))
        rot = (axis_angle_to_matrix(p["cam_rot"]) if self.optimize_camera_rotation
               else aux["rot0"])
        cam = {"rotation": rot, "translation": p["translation"]}
        proj = project_points(cam, self._mapped_joints(joints), self.focal_length, aux["center"])
        torso = _index(TORSO_OPENPOSE_IDXS, proj.device)
        err = torch.sum((proj[:, torso] - aux["gt_xy"][:, torso]) ** 2)
        depth = torch.sum((p["translation"][:, 2] - self.trans_estimation) ** 2)
        return {"data": err, "depth": depth}

    def _stage2_terms(self, p: dict, aux: dict) -> Dict[str, torch.Tensor]:
        """Stage 2: the confidence-weighted reprojection error of every
        keypoint and the prior, of ``{pose_body, global_orient, betas}``."""
        _, joints = self._fk(p["betas"], p["global_orient"], p["pose_body"])
        cam = {"rotation": aux["rot"], "translation": aux["translation"]}
        proj = project_points(cam, self._mapped_joints(joints), self.focal_length, aux["center"])
        conf = aux["conf"]
        err = torch.sum(conf[..., None] * (proj - aux["gt_xy"]) ** 2) / (torch.sum(conf) + 1e-8)
        return {"data": err, "pose_pr": self._prior(p["pose_body"])}

    def _stage3_terms(self, pose_body: torch.Tensor, aux: dict) -> Dict[str, torch.Tensor]:
        """Stage 3: the prior and the mean joint distance to the stage-2
        joints, of the pose alone."""
        prior = self._prior(pose_body)
        _, joints = self._fk(aux["betas"], aux["orient"], pose_body)
        data = torch.mean(torch.sqrt(
            torch.sum((joints - aux["anchor_joints"]) ** 2, dim=-1) + 1e-12))
        return {"pose_pr": prior, "data": data}

    def _get_solvers(self, B: int, iterations: int, steps_per_iter: int):
        key = (B, iterations, steps_per_iter)
        if key in self._solvers:
            return self._solvers[key]
        kw = dict(iterations=iterations, steps_per_iter=steps_per_iter, lr=0.02)
        g = self.prior_scale
        base_pr = SELF_WEIGHTED_PRIOR if self.prior_form == "self" else STAGE2_SPECS["pose_pr"]
        specs2 = dict(STAGE2_SPECS, pose_pr=base_pr._replace(scale=base_pr.scale * g))
        specs3 = dict(STAGE3_SPECS, pose_pr=base_pr._replace(scale=base_pr.scale * g))
        solvers = (make_annealed_solver(self._stage1_terms, STAGE1_SPECS, **kw),
                   make_annealed_solver(self._stage2_terms, specs2, **kw),
                   make_annealed_solver(self._stage3_terms, specs3, **kw))
        self._solvers[key] = solvers
        return solvers

    def optimize(self, keypoints, iterations: int = 10, steps_per_iter: int = 10,
                 center=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
        """(result, metrics) of (25, 3) or (B, 25, 3) keypoints (x, y,
        confidence; numpy or a tensor) with ``center`` (2,) the principal
        point in pixels. result: ``pose_body`` (B, 69), ``global_orient``
        (B, 3), ``betas``, ``camera_translation`` (B, 3),
        ``camera_rotation`` (B, 3, 3); metrics: each stage's final terms."""
        kp = torch.as_tensor(keypoints, dtype=torch.float32, device=self.device)
        if kp.dim() == 2:
            kp = kp[None]
        B = kp.shape[0]
        gt_xy = kp[..., :2]
        # a real SMPL mesh carries the 45-row landmark set, so every BODY_25
        # keypoint maps; a synthetic 24-joint mesh weighs eyes, ears and feet 0
        has_landmarks = self.body_model.model.v_template.shape[0] > int(SMPL_VERTEX_LANDMARKS.max())
        table = SMPLX45_TO_OPENPOSE if has_landmarks else SMPL_TO_OPENPOSE
        conf = kp[..., 2] * torch.as_tensor((table >= 0).astype(np.float32),
                                            device=self.device)[None]
        center_arr = _center(center, B, self.device)
        n_betas = self.body_model.num_betas
        solve1, solve2, solve3 = self._get_solvers(B, iterations, steps_per_iter)

        # ---- stage 1: camera rotation and translation, global orientation, torso
        cam0 = init_camera(B, device=self.device)
        cam0["translation"][:, 2] = self.trans_estimation
        rot0 = cam0["rotation"]
        init1 = {"translation": cam0["translation"],
                 "global_orient": torch.zeros((B, 3), device=self.device)}
        if self.optimize_camera_rotation:
            init1["cam_rot"] = torch.zeros((B, 3), device=self.device)
        p1, h1 = solve1(init1, {"rot0": rot0, "center": center_arr, "gt_xy": gt_xy})
        with torch.no_grad():
            rot = axis_angle_to_matrix(p1["cam_rot"]) if self.optimize_camera_rotation else rot0

        # ---- stage 2: the whole body (pose, orientation, betas), every keypoint, the prior
        translation = p1["translation"].detach()
        init2 = {"pose_body": self._stage2_pose(B),
                 "global_orient": p1["global_orient"].detach(),
                 "betas": torch.zeros((B, n_betas), device=self.device)}
        p2, h2 = solve2(init2, {"rot": rot, "center": center_arr, "gt_xy": gt_xy, "conf": conf,
                                "translation": translation})

        # ---- stage 3: the pose refined around the stage-2 solution
        with torch.no_grad():
            _, anchor_joints = self._fk(p2["betas"], p2["global_orient"], p2["pose_body"])
        betas2, orient2 = p2["betas"].detach(), p2["global_orient"].detach()
        pose3, h3 = solve3(p2["pose_body"], {"betas": betas2, "orient": orient2,
                                             "anchor_joints": anchor_joints})
        result = {"pose_body": pose3.detach(), "global_orient": orient2, "betas": betas2,
                  "camera_translation": translation, "camera_rotation": rot}
        metrics = {
            "stage1_final_data": float(h1["data"][-1]),
            "stage2_final_data": float(h2["data"][-1]),
            "stage2_final_prior": float(h2["pose_pr"][-1]),
            "stage3_final_prior": float(h3["pose_pr"][-1]),
        }
        return result, metrics


def project_result_keypoints(fitter: ImageFitter, result: Dict[str, torch.Tensor],
                             center=None) -> np.ndarray:
    """(B, 25, 2) pixels of the fitted body's BODY_25 keypoints through the
    fitted camera, the quantity the reference renders against the image
    (``image_fitting.py:68,86``)."""
    with torch.no_grad():
        _, joints = fitter._fk(result["betas"], result["global_orient"], result["pose_body"])
        B = joints.shape[0]
        cam = {"rotation": result["camera_rotation"],
               "translation": result["camera_translation"]}
        proj = project_points(cam, fitter._mapped_joints(joints), fitter.focal_length,
                              _center(center, B, joints.device))
    return proj.cpu().numpy()


def save_keypoint_overlay(img_path: str, out_path: str, proj_xy: np.ndarray,
                          gt_xy: Optional[np.ndarray] = None, radius: int = 4) -> Optional[str]:
    """Draw projected (and optionally detected) keypoints over the image.
    Returns the written path, or None when PIL is not installed (the
    overlay is a diagnostic, as in render.py)."""
    try:
        from PIL import Image, ImageDraw
    except Exception:
        return None
    img = Image.open(img_path).convert("RGB")
    draw = ImageDraw.Draw(img)

    def dots(xy, color):
        for x, y in np.asarray(xy).reshape(-1, 2):
            if np.isfinite(x) and np.isfinite(y):
                draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                             outline=color, width=2)

    if gt_xy is not None:
        dots(gt_xy, (60, 200, 60))     # green: the detected keypoints
    dots(proj_xy, (230, 70, 70))       # red: the fitted model's projection
    img.save(out_path)
    return out_path


def run_cli(args) -> None:
    """``cli fit-image``: ``<image-folder>/kpts.npz`` (key "0", or else the
    first), the principal point from ``img.jpg`` when PIL can open it."""
    import os

    from posendf_torch.field import load_field
    from posendf_torch.smpl import BodyModel

    field = load_field(args.ckpt, config=args.config, device=args.device)
    bm = BodyModel(bm_path=args.bm_path, device=args.device)
    with np.load(os.path.join(args.image_folder, "kpts.npz")) as z:
        key = "0" if "0" in z else list(z.keys())[0]
        keypoints = np.asarray(z[key], np.float32)
    center = None
    img_path = os.path.join(args.image_folder, "img.jpg")
    if os.path.exists(img_path):
        try:
            from PIL import Image

            w, h = Image.open(img_path).size
            center = np.array([w / 2.0, h / 2.0], np.float32)
        except Exception:
            center = None

    fitter = ImageFitter(field, bm, prior_form=args.prior_form)
    result, metrics = fitter.optimize(keypoints, center=center)
    for k, v in metrics.items():
        print(f"{k}: {v:0.8f}")
    if args.out:
        np.savez(args.out, **{k: v.cpu().numpy() for k, v in result.items()})
        print(f"wrote {args.out}")
    if args.save_mesh or args.render:
        from posendf_torch.experiments.render import export_pose_meshes

        out_dir = args.mesh_dir or args.image_folder
        export_pose_meshes(out_dir, bm, [("fit", result["pose_body"])],
                           save_mesh=args.save_mesh, render=args.render,
                           betas=result["betas"], global_orient=result["global_orient"])
        # the projected keypoints over the source image, when there is one
        # (the reference renders the fit against the image, image_fitting.py:68,86)
        if os.path.exists(img_path):
            proj = project_result_keypoints(fitter, result, center=center)
            gt = keypoints.reshape(-1, 25, 3)[..., :2]
            overlay = save_keypoint_overlay(img_path, os.path.join(out_dir, "overlay.png"),
                                            proj, gt)
            if overlay:
                print(f"wrote keypoint overlay -> {overlay}")
        print(f"wrote meshes/renders -> {out_dir}")
