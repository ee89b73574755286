"""What the quality drivers share (``scripts/torch_quality_grid.py``,
``torch_interp_quality.py``, ``torch_partial_quality.py``,
``torch_fit_image_quality.py``): the run's device and the card it names in
its result, a trained field from a checkpoint file, the synthetic manifold
family a field was trained on, the true k-NN distance oracle, and the
result file.

The drivers run on the card unless given ``--device cpu``; without a card
they raise (``field.resolve_device``), they never fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

from posendf_torch.data.synthetic import manifold_family
from posendf_torch.field import Field, resolve_device

__all__ = ["add_device_arg", "card_fields", "load_trained_field",
           "gentle_family", "true_knn_mean", "write_result"]


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card, field.resolve_device) or cpu")


def card_fields(device: torch.device) -> dict:
    """``{"device", "card"}`` of a result: the device type, and on the card
    its name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (None on the CPU, or where
    ``nvidia-smi`` does not run)."""
    card = None
    if device.type == "cuda":
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=30, check=True).stdout.strip().splitlines()
            card = out[device.index or 0].strip() if out else None
        except (OSError, subprocess.SubprocessError):
            card = None
    return {"device": device.type, "card": card}


def load_trained_field(path: str, device: torch.device) -> Tuple[Field, Optional[int]]:
    """(field on ``device``, the step it was trained to) of a ``.msgpack``
    file in the JAX package's ``{"epoch", "state": {"params"}}`` layout
    (``torch_quality_grid.py --save-ckpt`` writes one)."""
    from posendf_torch.checkpoints import load_msgpack_params
    from posendf_torch.config import PoseNDFConfig

    state, epoch = load_msgpack_params(path)
    module = PoseNDFConfig().make_model()
    module.load_state_dict(state, strict=True)
    return Field(module.to(resolve_device(device))), epoch


def gentle_family(seed=123, lo=0.15, hi=0.4, latents=2) -> tuple:
    """The manifold family a quality run draws from
    (``scripts/quality_grid.py::gentle_family``): ``manifold_family`` seeded
    with ``seed`` (an int, or a list for a derived stream)."""
    return manifold_family(np.random.default_rng(seed), 21, latents=latents, freq_range=(lo, hi))


def true_knn_mean(poses, corpus: torch.Tensor, k: int = 5) -> np.ndarray:
    """(n,) mean of each pose's ``k`` nearest geodesic distances in
    ``corpus``: the exact streamed search (``ops/knn.geodesic_topk``,
    precision 'highest'), the oracle the closed loops measure against."""
    from posendf_torch.ops.knn import geodesic_topk

    q = torch.as_tensor(poses, dtype=torch.float32).to(corpus.device)
    d, _ = geodesic_topk(q.reshape(-1, 21, 4), corpus, k=k, precision="highest")
    return d.mean(-1).cpu().numpy()


def write_result(result: dict, out: Optional[str]) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {out}", flush=True)
