"""Rolling checkpoint store: latest, previous and a validation-gated best.

Port of ``posendf_tpu/training/checkpoints.py`` with one format, the
reference's ``.tar`` (``model/train_posendf.py:147-156``): ``torch.save`` of
``{"epoch", "model_state_dict", "optimizer_state_dict"}``, the model under
the reference's keys (``enc.net.{j}.net.{0,2}.*``, ``dfnet.lin{l}.*``). So
``posendf_torch.load_field(<directory>)``, the JAX package's
``load_torch_checkpoint`` and the reference's own trainer all read it.

Every write goes to a temporary file first and lands with ``os.replace``;
``save`` renames the old latest to previous before that. ``restore`` falls
back to previous when latest cannot be read (a write torn by preemption) and
raises when a checkpoint's shapes do not match the model. The best
checkpoint's JSON sidecar carries the weights file's mtime and size, so a
sidecar that does not describe the file on disk counts as absent.
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Any, Dict, Optional

import torch

from posendf_torch.checkpoints import params_from_torch_state_dict, torch_state_dict_from_params

__all__ = ["CheckpointStore", "LATEST", "PREVIOUS", "BEST", "BEST_META"]

LATEST = "checkpoint_latest.tar"
PREVIOUS = "checkpoint_previous.tar"
BEST = "checkpoint_best.tar"
BEST_META = "checkpoint_best.json"


def _payload(module, optimizer, epoch: int) -> Dict[str, Any]:
    out = {"epoch": int(epoch),
           "model_state_dict": torch_state_dict_from_params(module.state_dict(),
                                                            parents=module.parents)}
    if optimizer is not None:
        out["optimizer_state_dict"] = optimizer.state_dict()
    return out


def _write(payload: Dict[str, Any], path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load_into(payload: Dict[str, Any], module, optimizer, path: str) -> int:
    """Copy a read checkpoint into ``module`` (and ``optimizer``); raise on a
    shape that does not match the model."""
    feature_size = module.enc.feature_size if module.enc is not None else 6
    state = params_from_torch_state_dict(payload["model_state_dict"], parents=module.parents,
                                         feature_size=feature_size)
    want = module.state_dict()
    for k in sorted(set(want) | set(state)):
        a = tuple(state[k].shape) if k in state else None
        b = tuple(want[k].shape) if k in want else None
        if a != b:
            raise ValueError(
                f"checkpoint {path} does not match the model: restored leaf {k} has shape "
                f"{a}, the current config expects {b}. Either restore with the original "
                "config or move/delete the checkpoint directory.")
    module.load_state_dict(state, strict=True)
    if optimizer is not None and "optimizer_state_dict" in payload:
        optimizer.load_state_dict(payload["optimizer_state_dict"])
    return int(payload["epoch"])


class CheckpointStore:
    """Checkpoints of one training run in ``directory``."""

    def __init__(self, directory: str, create: bool = True):
        self.directory = directory
        if create:
            os.makedirs(directory, exist_ok=True)

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, LATEST)

    def save(self, module, optimizer, epoch: int) -> str:
        """Roll latest -> previous, then atomically write the new latest."""
        tmp = self.latest_path + ".tmp"
        torch.save(_payload(module, optimizer, epoch), tmp)
        if os.path.exists(self.latest_path):
            os.replace(self.latest_path, os.path.join(self.directory, PREVIOUS))
        os.replace(tmp, self.latest_path)
        return self.latest_path

    def restore(self, module, optimizer=None) -> Optional[int]:
        """Load the latest checkpoint (the previous one if latest cannot be
        read) into ``module`` and ``optimizer``; its epoch, or None if
        there is none."""
        for name in (LATEST, PREVIOUS):
            path = os.path.join(self.directory, name)
            if not os.path.exists(path):
                continue
            try:
                payload = torch.load(path, map_location="cpu", weights_only=True)
            except Exception as e:  # a torn write: what the rolling pair is for
                warnings.warn(f"checkpoint {path} failed to restore ({type(e).__name__}: "
                              f"{e}); falling back", stacklevel=2)
                continue
            return _load_into(payload, module, optimizer, path)
        return None

    # ---- validation-gated best checkpoint ----

    def best_info(self) -> Optional[Dict[str, Any]]:
        """``{"epoch", "metric", "mode"}`` of the stored best checkpoint, or
        None if there is none or its sidecar does not describe it."""
        path = os.path.join(self.directory, BEST_META)
        try:
            with open(path) as f:
                info = json.load(f)
            st = os.stat(os.path.join(self.directory, BEST))
        except (OSError, ValueError):
            return None
        stamp = info.pop("stamp", {})
        if (int(stamp.get("mtime_ns", -1)) != st.st_mtime_ns
                or int(stamp.get("size", -1)) != st.st_size):
            return None
        return info

    def save_best(self, module, optimizer, epoch: int, metric: float,
                  mode: str = "min") -> Optional[str]:
        """Save as the best checkpoint iff ``metric`` beats the stored one
        (``mode`` "min" for losses, "max" for scores); a NaN metric never
        does, and a stored NaN counts as absent. Returns the path, or None."""
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        metric = float(metric)
        if math.isnan(metric):
            return None
        info = self.best_info()
        if info is not None and not math.isnan(float(info["metric"])):
            prev = float(info["metric"])
            if (metric >= prev) if mode == "min" else (metric <= prev):
                return None
        path = os.path.join(self.directory, BEST)
        _write(_payload(module, optimizer, epoch), path)
        st = os.stat(path)
        meta = os.path.join(self.directory, BEST_META)
        with open(meta + ".tmp", "w") as f:
            json.dump({"epoch": int(epoch), "metric": metric, "mode": mode,
                       "stamp": {"mtime_ns": st.st_mtime_ns, "size": st.st_size}}, f)
        os.replace(meta + ".tmp", meta)
        return path

    def restore_best(self, module, optimizer=None) -> Optional[int]:
        """Load the best checkpoint; its epoch, or None if there is none."""
        path = os.path.join(self.directory, BEST)
        if not os.path.exists(path):
            return None
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return _load_into(payload, module, optimizer, path)
