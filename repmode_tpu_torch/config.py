"""Immutable experiment configuration.

The port's own copy of ``repmode_tpu.config`` (the two packages share no
module). Field names and defaults are the JAX package's, so a config written
by one reads in the other through the JSON round trip. ``EvalConfig.s2d``,
``EvalConfig.pallas_conv`` and ``EvalConfig.predictor`` select the serving
route and the predictor mode (``models/reparam.make_inference``,
``infer/predict.TiledPredictor``), with the JAX package's defaults (the
space-to-depth route, which the port's CLI turns off: ``cli/args.py``).
``ModelConfig.train_s2d`` runs the narrow levels of the net in the
space-to-depth layout, in training and eval mode, as in the JAX package
(``models/repmode.py``); it is on by default, and the CLI turns it off too.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Default 12-task list (reference config.py:10-27), sorted as the reference
# sorts it (main.py:117): task id == index into this tuple.
DEFAULT_DATASETS: Tuple[str, ...] = (
    "alpha_tubulin",
    "beta_actin",
    "desmoplakin",
    "dna",
    "fibrillarin",
    "lamin_b1",
    "membrane_caax_63x",
    "myosin_iib",
    "sec61_beta",
    "st6gal1",
    "tom20",
    "zo1",
)


@dataclass(frozen=True)
class ModelConfig:
    """MoDE U-Net hyperparameters (reference fnet/nn_modules/RepMode.py:8-42)."""

    name: str = "RepMode"
    mult_chan: int = 32
    in_channels: int = 1
    out_channels: int = 1
    num_experts: int = 5
    depth: int = 4
    kernel_size: int = 5
    train_impl: str = "auto"
    train_s2d: bool = True
    remat: bool = False
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


@dataclass(frozen=True)
class TrainConfig:
    """Training recipe (reference config.py:31-35)."""

    num_epochs: int = 1000
    batch_size: int = 8
    batch_size_eval: int = 8
    lr: float = 1e-4
    seed: int = 0
    compute_dtype: str = "bfloat16"
    patch_size: Tuple[int, int, int] = (32, 128, 128)
    random_flip_prob: float = 0.5
    interval_val: int = 20
    epoch_checkpoint: Tuple[int, ...] = ()
    interval_checkpoint: Optional[int] = None
    num_devices: int = 1
    on_device_pipeline: Optional[bool] = None
    device_bank_budget_bytes: int = 4 * 1024**3


@dataclass(frozen=True)
class EvalConfig:
    """Sliding-window inference protocol (reference fnet_model.py:149-223)."""

    patch_size: Tuple[int, int, int] = (32, 128, 128)
    overlap: float = 0.5
    gaussian_sigma_scale: float = 1 / 8
    save_test_preds: bool = False
    save_test_signals_and_targets: bool = False
    # space-to-depth serving route (models/reparam.plain_forward_s2d), and with
    # pallas_conv its depth-padded K5 chain (plain_forward_s2d_pallas)
    s2d: bool = True
    predictor: str = "fused"
    pallas_conv: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset construction (reference fnet/data/SSPdataset.py:15-100)."""

    adopted_datasets: Tuple[str, ...] = DEFAULT_DATASETS
    path_dataset_csv: str = "data/csvs"
    path_dataset_czi: str = "data"
    path_load_dataset: Optional[str] = None
    path_save_dataset: Optional[str] = None
    resize_factors: Tuple[float, float, float] = (1.0, 0.37241, 0.37241)
    num_workers: int = 4


@dataclass(frozen=True)
class Config:
    """Top-level experiment config."""

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: DataConfig = field(default_factory=DataConfig)
    path_exp_dir: Optional[str] = None
    path_load_model: Optional[str] = None
    exp_name: str = "exp"
    run_name: Optional[str] = None
    tags: Tuple[str, ...] = ()
    debugging: bool = False
    monitor_model: bool = False

    @property
    def num_tasks(self) -> int:
        return len(self.data.adopted_datasets)

    def task_index(self, dataset_name: str) -> int:
        return self.data.adopted_datasets.index(dataset_name)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def _build(klass, sub):
            kwargs = {}
            for f in dataclasses.fields(klass):
                if f.name not in sub:
                    continue
                v = sub[f.name]
                if f.name in _SUBTYPES and klass is Config:
                    kwargs[f.name] = _build(_SUBTYPES[f.name], v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
            return klass(**kwargs)

        return _build(cls, d)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


_SUBTYPES = {
    "model": ModelConfig,
    "train": TrainConfig,
    "eval": EvalConfig,
    "data": DataConfig,
}


def expanded_checkpoint_epochs(cfg: Config) -> Tuple[int, ...]:
    """Expand interval_checkpoint into explicit epochs (reference main.py:75-77)."""
    epochs = list(cfg.train.epoch_checkpoint)
    if cfg.train.interval_checkpoint is not None:
        times = int(cfg.train.num_epochs / cfg.train.interval_checkpoint)
        epochs.extend((i + 1) * cfg.train.interval_checkpoint for i in range(times))
    return tuple(epochs)
