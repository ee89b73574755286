"""Trainer for the pose distance field, on one device or data-parallel.

Port of ``posendf_tpu/training/trainer.py``. The reference's optimizer is
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

Data parallel (``mesh=``, a :class:`~posendf_torch.parallel.Mesh` of one
process a device): every rank draws the same global batch from the same
seeded batcher and takes its contiguous rows; one all-reduce of a flat
buffer a step carries the loss, its terms and every gradient leaf, as the
one all-reduce XLA inserts in the JAX trainer. The fused path
(``fused_train_grads`` on the local rows) divides the sum by the world size,
JAX's ``pmean``, which is the global mean only for equal shards, so uneven
shards raise there; the autodiff path weights each rank's terms by its
share of the rows, so the reduced loss and gradient are the global means
for any split. The parameters are broadcast from rank 0 at construction and
whenever they are replaced (matched head init, best-checkpoint restore);
Adam then runs on every rank on the same gradient. Only rank 0 writes the
config copy, the checkpoints and the metrics log; the other ranks wait at
a barrier. No ``DistributedDataParallel`` wrapper: the kernels' gradients
never pass through its hooks.
"""

from __future__ import annotations

import collections
import os
import shutil
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from posendf_torch.config import PoseNDFConfig, save_config
from posendf_torch.field import resolve_device
from posendf_torch.losses import training_loss
from posendf_torch.ops.fused_model import FieldWeights
from posendf_torch.ops.fused_train import fused_train_grads
from posendf_torch.parallel.mesh import (Mesh, all_reduce_mean, all_reduce_sum, barrier,
                                         broadcast_object, replicated, shard_batch)
from posendf_torch.training.checkpoints import CheckpointStore
from posendf_torch.training.metrics import MetricsLogger, RunningAverage
from posendf_torch.utils.profiling import SETUP_S, span

__all__ = ["Trainer", "make_optimizer", "make_train_step"]

_KEYS = ("total", "dist", "man_loss", "eikonal")


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 1e-4) -> torch.optim.Adam:
    """Adam with coupled L2: ``weight_decay * p`` is added to the gradient
    before the moment updates (torch's Adam, not AdamW). The process's first
    call records its seconds in ``utils.profiling.SETUP_S["make_optimizer"]``
    (it loads ``torch._dynamo``)."""
    t0 = time.perf_counter()
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    SETUP_S.setdefault("make_optimizer", time.perf_counter() - t0)
    return opt


class _NullLogger:
    """The metrics log of a rank that writes none."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _flat(values) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in values])


def _unflat(buf: torch.Tensor, like) -> list:
    out, at = [], 0
    for v in like:
        out.append(buf[at:at + v.numel()].reshape(v.shape))
        at += v.numel()
    return out


def make_train_step(module, optimizer: torch.optim.Optimizer, *, loss_type: str,
                    weights: Dict[str, float], remat: bool = False, fused: bool = False,
                    mesh: Optional[Mesh] = None) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """The train step ``batch -> metrics``: it updates ``module``'s
    parameters and ``optimizer``'s state in place and returns the loss
    terms and the total as 0-d tensors on the device.

    ``fused``: the loss and the parameter gradient come from
    ``ops.fused_train.fused_train_grads`` (two CUDA kernels; their plain
    version on the CPU) instead of autograd; lrelu/relu and fp32 only.
    ``remat``: recompute the loss forwards in the backward
    (``losses.training_loss(remat=True)``).

    ``mesh``: ``step(batch)`` takes the GLOBAL batch (the same on every
    rank), computes on this rank's contiguous rows and all-reduces one flat
    buffer of loss, terms and gradients (see the module docstring): the
    fused path raises on a batch that does not divide over the ranks; the
    autodiff path returns the global means for any split.
    ``step(local, global_rows)`` takes this rank's rows already cut (by
    ``shard_batch(mesh, batch, even=fused)``) and the global batch's
    ``(pose, man_poses)`` row counts."""
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
    term_keys = ("dist", "man_loss", "eikonal")

    def step(batch: Dict[str, torch.Tensor],
             global_rows: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        with span("posendf.train.step"):
            return _step(batch, global_rows)

    def _step(batch, global_rows):
        local = batch
        if mesh is not None and global_rows is None:
            local = shard_batch(mesh, batch, even=fused)
            global_rows = (len(batch["pose"]), len(batch["man_poses"]))
        if fused:
            with span("posendf.train.pack"):
                # packed anew each step: the kernels read the weights of this step
                w = FieldWeights.from_module(module)
                if w.device.type == "cuda":     # the packs the kernels read; the CPU path reads none
                    w.packed()
                    w.tc_packed()
            with span("posendf.train.grads"):
                total, terms, grads = fused_train_grads(w, local["pose"], local["dist"],
                                                        local["man_poses"], **kw)
                grads = [grads[name] for name, _ in named]
            if mesh is not None:
                with span("posendf.train.allreduce"):
                    # each rank's means over its equal shard; their mean is the global one
                    vals = [total] + [terms[k] for k in term_keys] + grads
                    vals = _unflat(all_reduce_mean(mesh, _flat(vals)), vals)
                    total, terms, grads = vals[0], dict(zip(term_keys, vals[1:4])), vals[4:]
            for (_, p), g in zip(named, grads):
                p.grad = g
        else:
            with span("posendf.train.grads"):
                optimizer.zero_grad(set_to_none=True)
                total, terms = training_loss(module, local["pose"], local["dist"],
                                             local["man_poses"], remat=remat, **kw)
                if mesh is not None:
                    # each rank's term weighted by its share of the rows: the sum
                    # over ranks is the mean over the global batch, for any split
                    fn = len(local["pose"]) / global_rows[0]
                    fm = len(local["man_poses"]) / global_rows[1]
                    terms = {"dist": terms["dist"] * fn, "man_loss": terms["man_loss"] * fm,
                             "eikonal": terms["eikonal"] * fn}
                    total = (weights["dist"] * terms["dist"]
                             + weights["man_loss"] * terms["man_loss"]
                             + weights["eikonal"] * terms["eikonal"])
                total.backward()
            if mesh is not None:
                with span("posendf.train.allreduce"):
                    vals = ([total.detach()] + [terms[k].detach() for k in term_keys]
                            + [p.grad for _, p in named])
                    vals = _unflat(all_reduce_sum(mesh, _flat(vals)), vals)
                    total, terms = vals[0], dict(zip(term_keys, vals[1:4]))
                    for (_, p), g in zip(named, vals[4:]):
                        p.grad = g
        with span("posendf.train.adam"):
            optimizer.step()
        return {k: v.detach() for k, v in dict(terms, total=total).items()}

    return step


class Trainer:
    """Trains a PoseNDF end to end on one device, or data-parallel over a
    mesh of processes.

    Usage::

        trainer = Trainer(cfg, device="cuda")
        trainer.fit(batcher, epochs=...)

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` for the CPU. With ``mesh`` (``parallel.make_mesh()``
    in every rank of a process group) the device is the mesh's, each step
    takes the global batch, and only rank 0 writes files (see the module
    docstring). The initial weights come from a generator seeded with 0."""

    def __init__(self, cfg: PoseNDFConfig, device="cuda", config_path: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.is_main = mesh is None or mesh.is_main
        self.module = cfg.make_model(device=self.device)
        self.optimizer = make_optimizer(self.module.parameters(), cfg.train.optimizer_param,
                                        cfg.train.weight_decay)

        # the experiment directory as the reference lays it out: root_dir/exp_name/checkpoints
        self.exp_dir = os.path.join(cfg.experiment.root_dir, cfg.exp_name())
        if self.is_main:
            os.makedirs(self.exp_dir, exist_ok=True)
            if config_path and os.path.exists(config_path):
                shutil.copyfile(config_path,
                                os.path.join(self.exp_dir, os.path.basename(config_path)))
            else:
                save_config(cfg, os.path.join(self.exp_dir, "config.json"))
        barrier(mesh)
        self.store = CheckpointStore(os.path.join(self.exp_dir, "checkpoints"),
                                     create=self.is_main)
        self.metrics = MetricsLogger(self.exp_dir) if self.is_main else _NullLogger()
        self.epoch = 0
        self._warned_dead_head = False
        if cfg.train.continue_train:
            epoch = self.store.restore(self.module, self.optimizer)
            if epoch is not None:
                self.epoch = epoch + 1
        replicated(mesh, self.module.parameters())
        self._step = self._make_step()

    def _make_step(self):
        t = self.cfg.train
        return make_train_step(
            self.module, self.optimizer, loss_type=t.loss_type,
            weights={"dist": t.dist, "man_loss": t.man_loss, "eikonal": t.eikonal},
            remat=t.remat, fused=bool(t.fused_grads), mesh=self.mesh)

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch (numpy arrays or tensors; the
        global batch under a mesh)."""
        local, rows = self._local(batch)
        return self._step(self._to_device(local), rows)

    def _local(self, batch: Dict[str, Any]):
        """This rank's rows of a global batch, cut before any copy to the
        device, and the global ``(pose, man_poses)`` row counts."""
        rows = (len(batch["pose"]), len(batch["man_poses"]))
        if self.mesh is None:
            return batch, rows
        return shard_batch(self.mesh, batch, even=bool(self.cfg.train.fused_grads)), rows

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def load_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Replace the weights (rank 0's, under a mesh) and restart the
        optimizer's moments."""
        self.module.load_state_dict(state, strict=True)
        replicated(self.mesh, self.module.parameters())
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
        """One epoch over host batches (the global ones under a mesh); returns
        the averaged metrics, poses per second and the epoch's wall time.
        Each batch is cut to this rank's rows on the host and copied to the
        device ahead of its step (``prefetch_to_device``)."""
        from posendf_torch.data.pipeline import prefetch_to_device

        rows: "collections.deque[Tuple[int, int]]" = collections.deque()

        def local_batches():
            for batch in batches:
                local, r = self._local(batch)
                rows.append(r)      # before the yield: queued ahead of its batch
                yield local

        step_metrics = []
        n_poses = 0
        t0 = time.time()
        for local in prefetch_to_device(local_batches(), self.device):
            r = rows.popleft()
            n_poses += r[0]
            step_metrics.append(self._step(local, r))
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
        """The same loss terms on validation batches, with no update (under
        a mesh: this rank's rows, the terms weighted by its share and
        all-reduced)."""
        t = self.cfg.train
        step_metrics = []
        with torch.no_grad():
            for batch in batches:
                b = self._to_device(shard_batch(self.mesh, batch))
                total, terms = training_loss(
                    self.module, b["pose"], b["dist"], b["man_poses"], loss_type=t.loss_type,
                    weight_dist=t.dist, weight_man=t.man_loss, weight_eikonal=t.eikonal)
                if self.mesh is not None:
                    fn = len(b["pose"]) / len(batch["pose"])
                    fm = len(b["man_poses"]) / len(batch["man_poses"])
                    vals = all_reduce_sum(self.mesh, torch.stack(
                        [total.new_zeros(()), terms["dist"] * fn, terms["man_loss"] * fm,
                         terms["eikonal"] * fn]))
                    terms = dict(zip(_KEYS[1:], vals[1:]))
                    total = (t.dist * terms["dist"] + t.man_loss * terms["man_loss"]
                             + t.eikonal * terms["eikonal"])
                step_metrics.append(dict(terms, total=total))
        avg = self._drain_metrics(step_metrics, _KEYS)
        out = {k: m.avg for k, m in avg.items()}
        self.metrics.log(self.epoch, out, prefix="val")
        return out

    def save(self) -> Optional[str]:
        """Write this epoch's checkpoint (rank 0; the others wait)."""
        path = self.store.save(self.module, self.optimizer, self.epoch) if self.is_main else None
        barrier(self.mesh)
        return path

    def restore_best(self) -> Optional[int]:
        """Load the validation-best checkpoint into the live state; its
        epoch, or None if there is none."""
        epoch = self.store.restore_best(self.module, self.optimizer)
        replicated(self.mesh, self.module.parameters())
        return epoch

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
        if val_batcher is not None and val_every < 1:
            raise ValueError(f"val_every must be >= 1, got {val_every}")
        stale = 0
        for _ in range(epochs):
            stats = self.train_epoch(batcher.epoch(self.epoch))
            if self.epoch % log_every == 0 and self.is_main:
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
            if not np.isnan(metric) and self.is_main:
                saved = self.store.save_best(self.module, self.optimizer, self.epoch - 1,
                                             metric, mode=val_mode)
            # rank 0 decides; every rank counts the same stale run and stops together
            saved = broadcast_object(self.mesh, saved)
            if saved is not None:
                stale = 0
                print(f"val epoch {self.epoch - 1}: {val_metric}={metric:.6f} "
                      "(new best; retained)")
                continue
            stale += 1
            info = broadcast_object(self.mesh, self.store.best_info() if self.is_main else None)
            info = info or {}
            print(f"val epoch {self.epoch - 1}: {val_metric}={metric:.6f} (best remains "
                  f"{info.get('metric', float('nan')):.6f} @ epoch {info.get('epoch', '?')}; "
                  f"stale {stale})")
            if early_stop_patience and stale >= early_stop_patience:
                print(f"early stop: {val_metric} has not improved in {stale} consecutive "
                      f"validations (patience {early_stop_patience})")
                break
        return self
