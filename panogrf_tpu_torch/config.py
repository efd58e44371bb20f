"""Typed configuration tree: the port's own copy of
``panogrf_tpu/config.py``.

Each subsystem gets a dataclass; the YAML files under ``configs/`` use the
reference recipes' knob names, and ``load_config`` maps them onto the
tree exactly as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = "m3d"
    height: int = 512
    width: int = 1024
    m3d_dist: float = 0.5
    seq_len: int = 3
    reference_idx: int = 1
    # MV protocol (reference run_training_mv.py / get_database_split_mv):
    # refs = range(reference_idx), queries = test_views.
    test_views: Tuple[int, ...] = ()
    min_depth: float = 0.5
    max_depth: float = 15.0
    use_lmdb: bool = False
    shard_dir: Optional[str] = None      # offline array shards
    total_cnt: int = 20000


@dataclasses.dataclass
class MonoConfig:
    mono_height: int = 512
    mono_width: int = 1024
    mono_num_layers: int = 18
    mono_net: str = "UniFuse"
    mono_fusion: str = "cee"
    se_in_fusion: bool = True
    mono_uncertainty: bool = False
    max_depth: float = 10.0
    min_depth: float = 0.1
    use_wrap_padding: bool = True
    dnet_ckpt: Optional[str] = None       # DNET_ckpt


@dataclasses.dataclass
class MVSConfig:
    depth_height: int = 256
    depth_width: int = 512
    mvs_min_depth: float = 0.1
    mvs_max_depth: float = 10.0
    net: str = "Equi"
    num_layers: int = 18
    fusion: str = "biproj"
    se_in_fusion: bool = False
    cost_volume_channels: int = 64
    magnet_num_samples: int = 5           # MAGNET_num_samples
    magnet_sampling_range: float = 3.0    # MAGNET_sampling_range
    fixed_sigma: float = 0.5
    use_depth_sampling: bool = True
    mono_uncertainty: bool = False
    mvs_uncertainty: bool = False
    group_num: int = 1
    with_sin: bool = False
    wo_mono_feat: bool = False
    use_wrap_padding: bool = True
    use_new_reg3dnet: bool = False        # MVSNet CostRegNet regularizer
    mvsnet_ckpt: Optional[str] = None     # mvsnet_pretrained_path


@dataclasses.dataclass
class RendererConfig:
    network: str = "neuray_gen"
    height: int = 512
    width: int = 1024
    min_depth: float = 0.5
    max_depth: float = 15.0
    depth_sample_num: int = 64
    fine_depth_sample_num: int = 64
    use_hierarchical_sampling: bool = True
    fine_depth_use_all: bool = False
    use_disp: bool = True
    ray_batch_num: int = 2048
    use_depth_loss: bool = False
    use_self_hit_prob: bool = False
    use_ray_mask: bool = True
    use_polar_weighted_loss: bool = False
    render_depth: bool = True
    render_uncert: bool = False
    wo_stereo: bool = False
    uncert_tune: bool = False
    use_wrap_padding: bool = True


@dataclasses.dataclass
class TrainConfig:
    name: str = "run"
    total_step: int = 100000
    val_interval: int = 10000
    save_interval: int = 20000
    lr_type: str = "exp_decay"
    lr_init: float = 4e-4
    decay_step: int = 20000
    decay_rate: float = 0.5
    batch_size: int = 1
    seed: int = 2022
    key_metric_name: str = "psnr_nr_fine"
    loss: Tuple[str, ...] = ("render",)
    save_dir: str = "data/model"


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mono: MonoConfig = dataclasses.field(default_factory=MonoConfig)
    mvs: MVSConfig = dataclasses.field(default_factory=MVSConfig)
    renderer: RendererConfig = dataclasses.field(
        default_factory=RendererConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


# Reference-yaml key -> (section, field) remapping for keys whose names
# changed case or prefix.
_KEY_ALIASES = {
    "MAGNET_num_samples": ("mvs", "magnet_num_samples"),
    "MAGNET_sampling_range": ("mvs", "magnet_sampling_range"),
    "DNET_ckpt": ("mono", "dnet_ckpt"),
    "mvsnet_pretrained_path": ("mvs", "mvsnet_ckpt"),
    "dataset_name": ("data", "dataset_name"),
    "learning_rate": ("train", "lr_init"),   # depth recipes' knob name
    "total_iter": ("train", "total_step"),
}


def load_config(path: str | Path | None = None,
                overrides: dict | None = None) -> Config:
    """Load a flat reference-style YAML into the typed tree.

    Unknown keys are ignored (the reference has ~150 knobs; the tree holds
    the ones the JAX package maps).
    """
    flat: dict = {}
    if path is not None:
        import yaml
        with open(path) as f:
            flat.update(yaml.safe_load(f) or {})
    if overrides:
        flat.update(overrides)

    cfg = Config()
    sections = {
        "data": cfg.data, "mono": cfg.mono, "mvs": cfg.mvs,
        "renderer": cfg.renderer, "train": cfg.train,
    }
    for key, value in flat.items():
        if key in _KEY_ALIASES:
            sec, field = _KEY_ALIASES[key]
            setattr(sections[sec], field, value)
            continue
        if key == "lr_cfg" and isinstance(value, dict):
            for k2, v2 in value.items():
                if hasattr(cfg.train, k2):
                    setattr(cfg.train, k2, v2)
            continue
        if key == "loss" and isinstance(value, list):
            cfg.train.loss = tuple(value)
            continue
        for sec in sections.values():
            if hasattr(sec, key):
                setattr(sec, key, value)
    return cfg
