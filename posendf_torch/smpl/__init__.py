"""SMPL body model of the port (``posendf_tpu/smpl``'s counterpart)."""

from posendf_torch.smpl.body_model import BodyModel, BodyModelOutput
from posendf_torch.smpl.lbs import SMPLModel, lbs_forward, load_smpl_model, synthetic_model

__all__ = [
    "BodyModel", "BodyModelOutput",
    "SMPLModel", "lbs_forward", "load_smpl_model", "synthetic_model",
]
