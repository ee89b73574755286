"""The system under test, ``posendf_torch``, as the benchmark builds it.

The benchmark takes from the program only its entry points, its kernels and
what its trace names them; the weights are the benchmark's own, copied into
the program's module.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "posendf_tpu")

__all__ = ["build_module", "forbidden_modules", "FORBIDDEN"]


def build_module(config: dict, spec: dict, weights: Dict[str, torch.Tensor],
                 device: torch.device):
    """The port's PoseNDF of ``config`` on ``device``, holding ``weights``."""
    from posendf_torch.config import config_from_dict

    raw = {"model": config["model"], "train": config.get("train", {})}
    module = config_from_dict(raw).make_model(device=device)
    if tuple(module.parents) != spec["parents"]:
        raise ValueError("the program's kinematic tree is not the configuration's")
    module.load_state_dict(weights, strict=True)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
