"""Config system: typed dataclasses, YAML/JSON files and ``DGDM_*``
environment overrides (counterpart of the JAX package's ``utils/config.py``;
the same schema, so ``configs/*.yaml`` load into both packages alike).

``load_config`` merges overrides and the environment into a file's mapping
and validates; ``save_config`` writes atomically with a ``.bak`` of the old
file; ``config_transaction`` puts the old content back on error.
Environment overrides take dotted paths (``DGDM_MODEL__HIDDEN_DIMS``) and
YAML-parsed values. PyYAML is imported only where YAML is read or written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional

from .exceptions import ConfigurationError

__all__ = [
    "DGDMConfig", "ExperimentConfig", "ModelConfig", "DataConfig",
    "TrainingConfig", "HardwareConfig", "LoggingConfig",
    "ClassificationConfig", "RegressionConfig", "AdvancedConfig",
    "load_config", "save_config", "merge_configs", "config_transaction",
    "config_from_dict", "config_to_dict", "apply_env_overrides",
]


@dataclass
class ExperimentConfig:
    name: str = "dgdm_experiment"
    seed: int = 42
    debug: bool = False


@dataclass
class ModelConfig:
    node_features: int = 768
    hidden_dims: List[int] = field(default_factory=lambda: [512, 256, 128])
    num_diffusion_steps: int = 10
    attention_heads: int = 8
    dropout: float = 0.1
    graph_layers: int = 4
    use_spatial_attention: bool = True
    use_hierarchical: bool = True
    diffusion_schedule: str = "cosine"
    activation: str = "gelu"
    normalization: str = "layer"
    pooling: str = "attention"
    num_classes: Optional[int] = None
    regression_targets: int = 0
    # additions over the reference's schema
    # the JAX model reads the edge width off its input; the port's layers fix
    # it at construction, so the train CLI sets it from the data
    edge_features: int = 2
    neighbors_spatial: int = 8       # K for spatial kNN edges
    neighbors_morphological: int = 16
    compute_dtype: str = "bfloat16"  # matmul dtype
    param_dtype: str = "float32"
    # spatial attention [B,H,N,N] buffer dtype; softmax math stays f32
    attention_traffic_dtype: Optional[str] = None
    # block-local spatial attention window (None = dense all-pairs parity);
    # requires Morton-sorted nodes (data.spatial_sort) to be meaningful
    spatial_window: Optional[int] = None
    # banded (Morton-window) message passing in the GraphEncoder (None =
    # dense parity); exact when graphs are built with data.knn_window
    graph_window: Optional[int] = None
    # Mixture-of-Experts residual FFN after the message-passing stack
    # (0 = off)
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity: float = 1.5


@dataclass
class DataConfig:
    dataset_type: str = "slide"  # slide | graph | patch
    batch_size: int = 4
    num_workers: int = 8
    train_split: float = 0.7
    val_split: float = 0.15
    test_split: float = 0.15
    augmentations: str = "light"  # none | light | strong
    max_slides_per_split: Optional[int] = None
    cache_graphs: bool = True
    shuffle_train: bool = True
    patch_size: int = 256
    magnifications: List[float] = field(default_factory=lambda: [20.0])
    tissue_threshold: float = 0.8
    max_patches: int = 1000
    feature_extractor: str = "dinov2"
    # Morton-order nodes at graph build (semantic no-op; windowed spatial
    # attention needs it)
    spatial_sort: bool = False
    # restrict kNN searches to each node's ±1 Morton block band so banded
    # model compute (model.graph_window) is exact by construction
    knn_window: Optional[int] = None
    # node-count padding buckets: each batch has one bucket's static shape
    node_buckets: List[int] = field(default_factory=lambda: [128, 256, 512, 1024, 2048])


@dataclass
class TrainingConfig:
    max_epochs: int = 100
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    pretrain_epochs: int = 50
    finetune_epochs: int = 50
    masking_ratio: float = 0.15
    diffusion_noise_schedule: str = "cosine"
    use_contrastive_loss: bool = True
    contrastive_temperature: float = 0.1
    scheduler_type: str = "cosine"  # cosine | onecycle | none
    warmup_steps: int = 1000
    # opt-in for training a model.graph_window config on graphs NOT built
    # with data.knn_window (banded compute drops out-of-band edges; the
    # trainer's init_state refuses by default)
    allow_out_of_band_graphs: bool = False


@dataclass
class HardwareConfig:
    # kept for config compatibility: the data-parallel device count
    gpus: int = 1
    devices: Optional[int] = None  # explicit device count; None = all
    precision: str = "bf16-mixed"  # 32 | 16-mixed | bf16-mixed
    mesh_shape: Optional[List[int]] = None  # e.g. [8] for pure DP
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])


@dataclass
class LoggingConfig:
    logger_type: str = "tensorboard"  # tensorboard | wandb | csv | none
    log_level: str = "INFO"
    save_top_k: int = 3
    monitor_metric: str = "val_loss"


@dataclass
class ClassificationConfig:
    enabled: bool = False
    num_classes: int = 2
    class_weights: Optional[List[float]] = None
    label_smoothing: float = 0.0


@dataclass
class RegressionConfig:
    enabled: bool = False
    num_targets: int = 1
    loss_type: str = "mse"  # mse | mae | huber
    predict_uncertainty: bool = False


@dataclass
class SurvivalConfig:
    """Survival-analysis task (reference SurvivalHead,
    ``models/decoders.py:323-496``): labels are (time, event) pairs."""
    enabled: bool = False
    mode: str = "cox"        # cox | discrete
    num_intervals: int = 10  # discrete-time bins


@dataclass
class AdvancedConfig:
    gradient_clip_val: float = 1.0
    accumulate_grad_batches: int = 1
    check_val_every_n_epoch: int = 1
    enable_progress_bar: bool = True
    enable_model_summary: bool = True


@dataclass
class DGDMConfig:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    classification: ClassificationConfig = field(default_factory=ClassificationConfig)
    regression: RegressionConfig = field(default_factory=RegressionConfig)
    survival: SurvivalConfig = field(default_factory=SurvivalConfig)
    advanced: AdvancedConfig = field(default_factory=AdvancedConfig)

    def validate(self) -> None:
        m, t, d = self.model, self.training, self.data
        if m.node_features <= 0:
            raise ConfigurationError("model.node_features must be positive", {"value": m.node_features})
        if not m.hidden_dims:
            raise ConfigurationError("model.hidden_dims must be non-empty")
        if any(h <= 0 for h in m.hidden_dims):
            raise ConfigurationError("model.hidden_dims entries must be positive", {"value": m.hidden_dims})
        if m.num_diffusion_steps <= 0:
            raise ConfigurationError("model.num_diffusion_steps must be positive")
        if m.attention_heads <= 0 or m.hidden_dims[-1] % m.attention_heads != 0:
            raise ConfigurationError(
                "model.attention_heads must divide the final hidden dim",
                {"heads": m.attention_heads, "hidden": m.hidden_dims[-1]},
            )
        if not 0.0 <= m.dropout < 1.0:
            raise ConfigurationError("model.dropout must be in [0, 1)")
        if m.diffusion_schedule not in ("linear", "cosine", "sigmoid"):
            raise ConfigurationError("model.diffusion_schedule must be linear|cosine|sigmoid")
        if m.pooling not in ("mean", "max", "attention", "set2set"):
            raise ConfigurationError("model.pooling must be mean|max|attention|set2set")
        if not 0.0 < t.masking_ratio < 1.0:
            raise ConfigurationError("training.masking_ratio must be in (0, 1)")
        if abs(d.train_split + d.val_split + d.test_split - 1.0) > 1e-6:
            raise ConfigurationError(
                "data splits must sum to 1.0",
                {"sum": d.train_split + d.val_split + d.test_split},
            )
        if sorted(d.node_buckets) != list(d.node_buckets) or not d.node_buckets:
            raise ConfigurationError("data.node_buckets must be non-empty ascending")


_SECTION_TYPES = {f.name: f.type for f in dataclasses.fields(DGDMConfig)}


def _coerce_section(cls, raw: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    return cls(**kwargs)


def config_from_dict(raw: dict) -> DGDMConfig:
    """Build a typed config from a (possibly partial) nested dict."""
    sections = {}
    for f in dataclasses.fields(DGDMConfig):
        sec = raw.get(f.name, {})
        if not isinstance(sec, dict):
            raise ConfigurationError(f"config section '{f.name}' must be a mapping", {"got": type(sec).__name__})
        sections[f.name] = _coerce_section(f.default_factory().__class__, sec)  # type: ignore[misc]
    return DGDMConfig(**sections)


def config_to_dict(cfg: DGDMConfig) -> dict:
    return dataclasses.asdict(cfg)


def _parse_env_value(value: str) -> Any:
    import yaml
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def apply_env_overrides(raw: dict, prefix: str = "DGDM_") -> dict:
    """Apply ``DGDM_SECTION__KEY=value`` environment overrides.

    Uses a double-underscore path separator so nested keys resolve (the
    reference flattened everything to top level — SURVEY §8.10). Values are
    YAML-parsed, so ``DGDM_MODEL__HIDDEN_DIMS="[256,128]"`` works.
    """
    out = json.loads(json.dumps(raw))  # deep copy
    for key, value in os.environ.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):].lower().split("__")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ConfigurationError(f"env override {key} path collides with non-mapping value")
        node[path[-1]] = _parse_env_value(value)
    return out


def merge_configs(base: dict, override: dict) -> dict:
    """Recursive dict merge; override wins; lists replace wholesale."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    path: str | Path | None = None,
    overrides: Optional[dict] = None,
    apply_env: bool = True,
    validate: bool = True,
) -> DGDMConfig:
    """Load a config from YAML/JSON, merge overrides + env, validate."""
    raw: dict = {}
    if path is not None:
        p = Path(path)
        if not p.exists():
            raise ConfigurationError("config file not found", {"path": str(p)})
        text = p.read_text()
        if p.suffix in (".yaml", ".yml"):
            import yaml
            raw = yaml.safe_load(text) or {}
        elif p.suffix == ".json":
            raw = json.loads(text)
        else:
            raise ConfigurationError("unsupported config format", {"path": str(p)})
        if not isinstance(raw, dict):
            raise ConfigurationError("config root must be a mapping", {"path": str(p)})
    if overrides:
        raw = merge_configs(raw, overrides)
    if apply_env:
        raw = apply_env_overrides(raw)
    cfg = config_from_dict(raw)
    if validate:
        cfg.validate()
    return cfg


def save_config(cfg: DGDMConfig | dict, path: str | Path, backup: bool = True) -> Path:
    """Atomic YAML save with optional ``.bak`` of any existing file."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if backup and p.exists():
        shutil.copy2(p, p.with_suffix(p.suffix + ".bak"))
    data = config_to_dict(cfg) if isinstance(cfg, DGDMConfig) else cfg
    import yaml
    fd, tmp = tempfile.mkstemp(dir=p.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=False, sort_keys=False)
        os.replace(tmp, p)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return p


@contextlib.contextmanager
def config_transaction(path: str | Path):
    """Context manager: restore the previous config file content on error."""
    p = Path(path)
    snapshot = p.read_bytes() if p.exists() else None
    try:
        yield p
    except BaseException:
        if snapshot is not None:
            p.write_bytes(snapshot)
        elif p.exists():
            p.unlink()
        raise
