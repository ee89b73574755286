"""Trainer for the pose distance field, on one device.

Port of ``posendf_tpu/training/trainer.py`` without the mesh (data-parallel
training waits: ROADMAP Queue 1 item 12). The reference's optimizer is
Adam with coupled L2 (weight decay added to the gradient before the moment
updates), which is ``torch.optim.Adam(weight_decay=...)`` and the same as the
JAX package's ``add_decayed_weights`` + ``adam``. The loss is
``w_dist * L1 + w_man * mean|d_manifold| + w_eik * eikonal``
(``losses.training_loss``); with ``train.fused_grads`` each step's loss and
full parameter gradient come from the CUDA train kernels
(``ops/fused_train.py``) instead of autograd.

Per-epoch rolling checkpoints (``CheckpointStore``, the reference's ``.tar``
layout), the hyperparameter-encoding experiment directory with the config
written beside it, a JSON-lines metrics log, resume, validation-gated best
retention and early stopping follow the JAX trainer. Per-step metrics stay
on the device; an epoch reads them back once. Two JAX settings are not read:
``train.ckpt_backend`` (the port writes the one ``.tar`` format) and
``train.fused_tile`` (the CUDA kernels' pose tile is fixed).
"""

from __future__ import annotations

import os
import shutil
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from posendf_torch.config import PoseNDFConfig, save_config
from posendf_torch.field import resolve_device
from posendf_torch.losses import training_loss
from posendf_torch.ops.fused_model import FieldWeights
from posendf_torch.ops.fused_train import fused_train_grads
from posendf_torch.training.checkpoints import CheckpointStore
from posendf_torch.training.metrics import MetricsLogger, RunningAverage

__all__ = ["Trainer", "make_optimizer", "make_train_step"]

_KEYS = ("total", "dist", "man_loss", "eikonal")


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 1e-4) -> torch.optim.Adam:
    """Adam with coupled L2: ``weight_decay * p`` is added to the gradient
    before the moment updates (torch's Adam, not AdamW)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def make_train_step(module, optimizer: torch.optim.Optimizer, *, loss_type: str,
                    weights: Dict[str, float], remat: bool = False,
                    fused: bool = False) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """The train step ``batch -> metrics``: it updates ``module``'s
    parameters and ``optimizer``'s state in place and returns the loss
    terms and the total as 0-d tensors on the device.

    ``fused``: the loss and the parameter gradient come from
    ``ops.fused_train.fused_train_grads`` (two CUDA kernels; their plain
    version on the CPU) instead of autograd; lrelu/relu and fp32 only.
    ``remat``: recompute the loss forwards in the backward
    (``losses.training_loss(remat=True)``)."""
    if fused and (not module.use_encoder or module.ff_enc
                  or module.activation not in ("lrelu", "relu")):
        raise ValueError("fused train step requires the standard "
                         "encoder+DFNet architecture with lrelu/relu")
    if fused and module.compute_dtype != "float32":
        raise ValueError(
            "fused train step runs fp32 only (module has compute_dtype="
            f"{module.compute_dtype!r}); drop fused_grads or reset that knob")
    kw = dict(loss_type=loss_type, weight_dist=weights["dist"],
              weight_man=weights["man_loss"], weight_eikonal=weights["eikonal"])
    named = list(module.named_parameters())

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if fused:
            # packed anew each step: the kernels read the weights of this step
            total, terms, grads = fused_train_grads(FieldWeights.from_module(module), batch["pose"],
                                                    batch["dist"], batch["man_poses"], **kw)
            for name, p in named:
                p.grad = grads[name]
        else:
            optimizer.zero_grad(set_to_none=True)
            total, terms = training_loss(module, batch["pose"], batch["dist"],
                                         batch["man_poses"], remat=remat, **kw)
            total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in dict(terms, total=total).items()}

    return step


class Trainer:
    """Trains a PoseNDF end to end on one device.

    Usage::

        trainer = Trainer(cfg, device="cuda")
        trainer.fit(batcher, epochs=...)

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` for the CPU. The initial weights come from a generator
    seeded with 0."""

    def __init__(self, cfg: PoseNDFConfig, device="cuda", config_path: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.module = cfg.make_model(device=self.device)
        self.optimizer = make_optimizer(self.module.parameters(), cfg.train.optimizer_param,
                                        cfg.train.weight_decay)

        # the experiment directory as the reference lays it out: root_dir/exp_name/checkpoints
        self.exp_dir = os.path.join(cfg.experiment.root_dir, cfg.exp_name())
        os.makedirs(self.exp_dir, exist_ok=True)
        if config_path and os.path.exists(config_path):
            shutil.copyfile(config_path, os.path.join(self.exp_dir, os.path.basename(config_path)))
        else:
            save_config(cfg, os.path.join(self.exp_dir, "config.json"))
        self.store = CheckpointStore(os.path.join(self.exp_dir, "checkpoints"))
        self.metrics = MetricsLogger(self.exp_dir)
        self.epoch = 0
        self._warned_dead_head = False
        if cfg.train.continue_train:
            epoch = self.store.restore(self.module, self.optimizer)
            if epoch is not None:
                self.epoch = epoch + 1
        self._step = self._make_step()

    def _make_step(self):
        t = self.cfg.train
        return make_train_step(
            self.module, self.optimizer, loss_type=t.loss_type,
            weights={"dist": t.dist, "man_loss": t.man_loss, "eikonal": t.eikonal},
            remat=t.remat, fused=bool(t.fused_grads))

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch (numpy arrays or tensors)."""
        return self._step(self._to_device(batch))

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def load_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Replace the weights and restart the optimizer's moments."""
        self.module.load_state_dict(state, strict=True)
        self.optimizer = make_optimizer(self.module.parameters(), self.cfg.train.optimizer_param,
                                        self.cfg.train.weight_decay)
        self._step = self._make_step()

    def matched_head_init(self, batch: Dict[str, Any]) -> Optional[Dict[str, float]]:
        """Opt-in from-scratch aid: moment-match the head to this batch's
        labels (``training/init_utils.py``). A no-op when resuming. Returns
        the measured moments, or None if skipped."""
        if self.epoch > 0:
            return None
        from posendf_torch.training.init_utils import moment_matched_head_init

        batch = self._to_device(batch)
        params = {k: v.detach().clone() for k, v in self.module.state_dict().items()}
        new_params, stats = moment_matched_head_init(self.module, params, batch["pose"],
                                                     batch["dist"])
        self.load_params(new_params)
        return stats

    @staticmethod
    def _drain_metrics(step_metrics, keys) -> Dict[str, RunningAverage]:
        """Average per-step metric dicts with one readback from the device."""
        avg = {k: RunningAverage() for k in keys}
        if step_metrics:
            host = torch.stack([torch.stack([m[k].float() for k in keys])
                                for m in step_metrics]).cpu().numpy()
            for row in host:
                for k, v in zip(keys, row):
                    avg[k].update(float(v))
        return avg

    def train_epoch(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """One epoch; returns the averaged metrics, poses per second and the
        epoch's wall time."""
        step_metrics = []
        n_poses = 0
        t0 = time.time()
        for batch in batches:
            n_poses += batch["pose"].shape[0]
            step_metrics.append(self.train_step(batch))
        avg = self._drain_metrics(step_metrics, _KEYS)
        dt = max(time.time() - t0, 1e-9)
        out = {k: m.avg for k, m in avg.items()}
        out["poses_per_sec"] = n_poses / dt
        out["epoch_time_s"] = dt
        self.metrics.log(self.epoch, out)
        # the dead-ReLU head: d == 0 for every pose, so every gradient is 0
        if (not self._warned_dead_head and step_metrics
                and out["man_loss"] == 0.0 and out["eikonal"] > 0.99
                and self.module.activation in ("lrelu", "relu")):
            self._warned_dead_head = True
            warnings.warn(
                "The distance head appears DEAD (d == 0 for every pose: man_loss == 0, "
                "eikonal ~= 1): all training gradients are exactly zero and the loss will "
                "never move. This is the reference init's coin flip for lrelu/relu heads; "
                "restart with dfnet.live_head=true (positive final-bias init), "
                "matched_head_init, or a different seed.", RuntimeWarning, stacklevel=2)
        return out

    def validate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """The same loss terms on validation batches, with no update."""
        t = self.cfg.train
        step_metrics = []
        with torch.no_grad():
            for batch in batches:
                b = self._to_device(batch)
                total, terms = training_loss(
                    self.module, b["pose"], b["dist"], b["man_poses"], loss_type=t.loss_type,
                    weight_dist=t.dist, weight_man=t.man_loss, weight_eikonal=t.eikonal)
                step_metrics.append(dict(terms, total=total))
        avg = self._drain_metrics(step_metrics, _KEYS)
        out = {k: m.avg for k, m in avg.items()}
        self.metrics.log(self.epoch, out, prefix="val")
        return out

    def save(self) -> str:
        return self.store.save(self.module, self.optimizer, self.epoch)

    def restore_best(self) -> Optional[int]:
        """Load the validation-best checkpoint into the live state; its
        epoch, or None if there is none."""
        return self.store.restore_best(self.module, self.optimizer)

    def fit(self, batcher, epochs: int, log_every: int = 1, save_every: int = 1, *,
            val_batcher=None, val_every: int = 100, val_metric: str = "total",
            val_mode: str = "min", val_batches: Optional[int] = None,
            early_stop_patience: int = 0) -> "Trainer":
        """Train for ``epochs`` epochs with rolling checkpoints.

        With ``val_batcher``, a validation pass runs every ``val_every``
        epochs and the best-so-far weights are kept as ``checkpoint_best.tar``
        (judged by ``val_metric`` and ``val_mode``); ``early_stop_patience``
        > 0 stops after that many validations in a row without improvement.
        """
        from posendf_torch.data.pipeline import prefetch_to_device

        if val_batcher is not None and val_every < 1:
            raise ValueError(f"val_every must be >= 1, got {val_every}")
        stale = 0
        for _ in range(epochs):
            stats = self.train_epoch(prefetch_to_device(batcher.epoch(self.epoch), self.device))
            if self.epoch % log_every == 0:
                print(f"epoch {self.epoch}: total={stats['total']:.6f} dist={stats['dist']:.6f} "
                      f"man={stats['man_loss']:.6f} eik={stats['eikonal']:.6f} "
                      f"({stats['poses_per_sec']:.0f} poses/s)")
            if self.epoch % save_every == 0:
                self.save()
            self.epoch += 1
            if val_batcher is None or self.epoch % val_every != 0:
                continue
            n = val_batches if val_batches is not None else len(val_batcher)
            metric = float(self.validate(val_batcher.sample_batch() for _ in range(n))[val_metric])
            saved = None
            if not np.isnan(metric):
                saved = self.store.save_best(self.module, self.optimizer, self.epoch - 1,
                                             metric, mode=val_mode)
            if saved is not None:
                stale = 0
                print(f"val epoch {self.epoch - 1}: {val_metric}={metric:.6f} "
                      "(new best; retained)")
                continue
            stale += 1
            info = self.store.best_info() or {}
            print(f"val epoch {self.epoch - 1}: {val_metric}={metric:.6f} (best remains "
                  f"{info.get('metric', float('nan')):.6f} @ epoch {info.get('epoch', '?')}; "
                  f"stale {stale})")
            if early_stop_patience and stale >= early_stop_patience:
                print(f"early stop: {val_metric} has not improved in {stale} consecutive "
                      f"validations (patience {early_stop_patience})")
                break
        return self
