"""The experiments of the port: the annealed-Adam engine, motion denoising
and its benchmark sweep, interpolation and mesh export
(``posendf_tpu/experiments``' counterparts)."""

from posendf_torch.experiments.denoise import MotionDenoiser, v2v_cm
from posendf_torch.experiments.interpolate import interpolate
from posendf_torch.experiments.optim import AnnealSpec, make_annealed_solver, run_annealed_adam
from posendf_torch.experiments.render import render_meshes, save_meshes, save_obj

__all__ = [
    "MotionDenoiser", "v2v_cm",
    "interpolate",
    "AnnealSpec", "make_annealed_solver", "run_annealed_adam",
    "render_meshes", "save_meshes", "save_obj",
]
