from posendf_torch.models.dfnet import DFNet
from posendf_torch.models.encoder import StructureEncoder
from posendf_torch.models.posendf import PoseNDF

__all__ = ["DFNet", "StructureEncoder", "PoseNDF"]
