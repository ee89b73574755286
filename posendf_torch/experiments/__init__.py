"""The experiments of the port: the annealed-Adam engine, motion denoising
and its benchmark sweep, partial-observation completion, image fitting,
interpolation and mesh export (``posendf_tpu/experiments``' counterparts)."""

from posendf_torch.experiments.camera import init_camera, project_points
from posendf_torch.experiments.denoise import MotionDenoiser, v2v_cm
from posendf_torch.experiments.fit_image import ImageFitter
from posendf_torch.experiments.interpolate import interpolate
from posendf_torch.experiments.optim import AnnealSpec, make_annealed_solver, run_annealed_adam
from posendf_torch.experiments.partial import (PartialCompleter, complete_by_retrieval, dof_mask,
                                               observation_mask)
from posendf_torch.experiments.render import render_meshes, save_meshes, save_obj

__all__ = [
    "init_camera", "project_points",
    "MotionDenoiser", "v2v_cm",
    "ImageFitter",
    "interpolate",
    "AnnealSpec", "make_annealed_solver", "run_annealed_adam",
    "PartialCompleter", "complete_by_retrieval", "dof_mask", "observation_mask",
    "render_meshes", "save_meshes", "save_obj",
]
