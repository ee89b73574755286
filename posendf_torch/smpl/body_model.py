"""BodyModel: the SMPL wrapper the experiments call.

Mirror of ``posendf_tpu/smpl/body_model.py`` (the reference wrapper's API,
``experiments/body_model.py:11-53``): ``BodyModel(bm_path, model_type,
num_betas)`` with a call ``(root_orient, pose_body, betas)`` that returns
``vertices``, ``faces``, ``Jtr``, ``betas``, ``body_pose`` and ``full_pose``.

``pose_body`` takes the reference's (B, 69) layout (23 body joints; the last
two are the hands, zero-padded by every caller), (B, 63) (the hands padded
here) or (B, 23, 3). Inputs (tensors or numpy) go to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from posendf_torch.smpl.lbs import (SMPL_VERTEX_LANDMARKS, SMPLModel, lbs_forward,
                                    load_smpl_model, synthetic_model, with_landmarks)

__all__ = ["BodyModel", "BodyModelOutput", "SMPL_VERTEX_LANDMARKS"]


@dataclasses.dataclass
class BodyModelOutput:
    vertices: torch.Tensor   # (B, V, 3)
    faces: np.ndarray        # (F, 3)
    Jtr: torch.Tensor        # (B, 45, 3) for a real SMPL mesh (24 skeleton joints and
                             # 21 landmarks, smplx order); (B, 24, 3) for smaller meshes
    betas: torch.Tensor
    body_pose: torch.Tensor  # (B, 69)
    full_pose: torch.Tensor  # (B, 72)


class BodyModel:
    """SMPL on ``device`` (the card unless the caller asks for the CPU): the
    file at ``bm_path``, the given ``model`` (moved to ``device``), or with
    neither the 128-vertex ``synthetic_model``."""

    def __init__(self, bm_path: Optional[str] = None, model_type: str = "smpl",
                 num_betas: int = 10, model: Optional[SMPLModel] = None, device="cuda"):
        from posendf_torch.field import resolve_device

        if model_type != "smpl":
            raise NotImplementedError(f"model_type={model_type!r}; only 'smpl' is supported")
        dev = resolve_device(device)
        if model is not None:
            self.model = model.to(dev)
        elif bm_path is not None:
            self.model = load_smpl_model(bm_path, num_betas=num_betas, device=dev)
        else:
            self.model = synthetic_model(num_betas=num_betas, device=dev)
        self.num_betas = num_betas

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def __call__(self, root_orient=None, pose_body=None, betas=None) -> BodyModelOutput:
        if pose_body is None:
            raise ValueError("pose_body is required")
        pose_body = self._tensor(pose_body)
        B = pose_body.shape[0]
        pose_body = pose_body.reshape(B, -1)
        if pose_body.shape[1] == 63:  # 21 joints: the hands padded with zeros
            pose_body = torch.cat([pose_body, pose_body.new_zeros((B, 6))], dim=1)
        if pose_body.shape[1] != 69:
            raise ValueError(f"pose_body must be (B, 63|69), got {tuple(pose_body.shape)}")
        root_orient = (pose_body.new_zeros((B, 3)) if root_orient is None
                       else self._tensor(root_orient))
        betas = (pose_body.new_zeros((B, self.num_betas)) if betas is None
                 else self._tensor(betas))
        vertices, joints = lbs_forward(self.model, betas, root_orient, pose_body)
        return BodyModelOutput(
            vertices=vertices,
            faces=self.model.faces,
            Jtr=with_landmarks(vertices, joints),
            betas=betas,
            body_pose=pose_body,
            full_pose=torch.cat([root_orient.reshape(B, 3), pose_body], dim=1),
        )
