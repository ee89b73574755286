"""Typed configuration, the same schema as ``posendf_tpu/config.py``.

The defaults are the ``configs/amass.yaml`` spec (the reference's
hyperparameters of record), so a caller with no YAML file needs no YAML
parser: ``yaml`` is imported only when :func:`load_config` is given a YAML
path. :func:`save_config` writes JSON (the same nested schema), which
:func:`load_config` reads back without ``yaml``. Unknown keys of the
reference schema are kept in each section's ``extra``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = [
    "DataConfig", "ExperimentConfig", "DFNetConfig", "StrEncConfig",
    "TrainConfig", "PoseNDFConfig", "load_config", "config_from_dict", "save_config",
]


@dataclass
class DataConfig:
    data_dir: str = "./posendf_data/"
    amass_dir: str = "./amass_raw/"
    sample_pt: int = 100000
    sample_distribution: List[float] = field(default_factory=lambda: [0.5, 0.5])
    sample_sigmas: List[float] = field(default_factory=lambda: [0.0, 0.001])
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExperimentConfig:
    bodymodel: str = "smpl"
    root_dir: str = "./experiments_out"
    exp_name: str = "main"
    num_part: int = 21
    val: bool = False
    val_every: int = 100
    test: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DFNetConfig:
    in_dim: int = 126
    dims: List[int] = field(default_factory=lambda: [256, 512, 1024, 512, 256, 64])
    act: str = "lrelu"
    beta: float = 100.0
    ff_enc: bool = False
    ff_freqs: int = 4
    compute_dtype: str = "float32"
    precision: str = "default"
    live_head: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class StrEncConfig:
    use: bool = True
    out_dim: int = 6
    in_dim: int = 84
    num_part: int = 21
    act: str = "lrelu"
    beta: float = 100.0
    corrected_tree: bool = False
    fused: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainConfig:
    device: str = "tpu"
    batch_size: int = 4
    num_pts: int = 5000
    continue_train: bool = True
    optimizer: str = "Adam"
    optimizer_param: float = 1e-5
    weight_decay: float = 1e-4
    num_worker: int = 8
    max_epoch: int = 200000
    loss_type: str = "l1"
    man_loss: float = 1.0
    dist: float = 1.0
    eikonal: float = 1.0
    flip: bool = False
    remat: bool = False
    fused_grads: bool = False
    fused_tile: int = 2048
    ckpt_backend: str = "msgpack"
    early_stop_patience: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PoseNDFConfig:
    data: DataConfig = field(default_factory=DataConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    dfnet: DFNetConfig = field(default_factory=DFNetConfig)
    strenc: StrEncConfig = field(default_factory=StrEncConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def exp_name(self) -> str:
        """Hyperparameter-encoding experiment directory name, the reference's
        scheme (as ``posendf_tpu.config.PoseNDFConfig.exp_name``)."""
        prefix = "flip_" if self.train.flip else ""
        return (
            f"{prefix}{self.experiment.exp_name}_{self.dfnet.act}_{self.train.loss_type}"
            f"_{self.train.optimizer_param}_dist{self.train.dist}_eik{self.train.eikonal}"
        )

    def make_model(self, generator=None, device=None):
        """A freshly initialized :class:`~posendf_torch.models.PoseNDF`."""
        from posendf_torch import kinematics
        from posendf_torch.models import PoseNDF

        return PoseNDF(
            num_joints=self.experiment.num_part,
            use_encoder=self.strenc.use,
            feature_size=self.strenc.out_dim,
            dfnet_dims=tuple(self.dfnet.dims),
            activation=self.dfnet.act,
            beta=self.dfnet.beta,
            parents=kinematics.parent_table(self.strenc.corrected_tree),
            use_fused=self.strenc.fused,
            ff_enc=self.dfnet.ff_enc,
            ff_freqs=self.dfnet.ff_freqs,
            compute_dtype=self.dfnet.compute_dtype,
            live_head=self.dfnet.live_head,
            generator=generator,
            device=device,
        )


def _take(d: Dict[str, Any], cls) -> Any:
    """Build a dataclass from a raw dict: known keys as fields, the rest in
    ``extra``."""
    names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
    known = {k: v for k, v in d.items() if k in names}
    extra = {k: v for k, v in d.items() if k not in names}
    return cls(**known, extra=extra)


def load_config(path: str) -> PoseNDFConfig:
    """Load the reference ``amass.yaml`` schema or the native one, from YAML
    or (``.json``) from JSON."""
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.safe_load(f) or {}
    return config_from_dict(raw or {})


def config_from_dict(raw: Dict[str, Any]) -> PoseNDFConfig:
    data = _take(raw.get("data", {}), DataConfig)
    exp = _take(raw.get("experiment", {}), ExperimentConfig)
    model = raw.get("model", {})
    dfnet = _take(model.get("DFNet", raw.get("dfnet", {})), DFNetConfig)
    strenc = _take(model.get("StrEnc", raw.get("strenc", {})), StrEncConfig)
    train = _take(raw.get("train", {}), TrainConfig)
    # the reference keeps the quat-flip switch under data:
    if "flip" in data.extra and "flip" not in raw.get("train", {}):
        train.flip = bool(data.extra["flip"])
    return PoseNDFConfig(data=data, experiment=exp, dfnet=dfnet, strenc=strenc, train=train)


def save_config(cfg: PoseNDFConfig, path: str) -> None:
    """Write ``cfg`` as JSON in the nested schema ``posendf_tpu``'s
    ``save_config`` writes as YAML (``extra`` keys inline)."""
    def enc(dc):
        d = dataclasses.asdict(dc)
        d.update(d.pop("extra", {}))
        return d

    raw = {
        "data": enc(cfg.data),
        "experiment": enc(cfg.experiment),
        "model": {"DFNet": enc(cfg.dfnet), "StrEnc": enc(cfg.strenc)},
        "train": enc(cfg.train),
    }
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
