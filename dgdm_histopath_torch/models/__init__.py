"""Model layer: DGDMModel, its encoders, heads, pooling and presets."""

from .decoders import (
    ClassificationHead,
    MultiTaskHead,
    RegressionHead,
    SurvivalHead,
    cox_partial_likelihood,
    cross_entropy_loss,
    discrete_survival_loss,
)
from .dgdm import DGDMModel
from .encoders import FeatureEncoder, GraphEncoder, HierarchicalEncoder, PositionalEncoder
from .pooling import (
    GlobalAttentionPool,
    GlobalMaxPool,
    GlobalMeanPool,
    GlobalSet2SetPool,
    make_pool,
)
from .presets import PRESETS, create_model, default_window_policy, list_presets

__all__ = [
    "DGDMModel",
    "FeatureEncoder", "GraphEncoder", "PositionalEncoder", "HierarchicalEncoder",
    "ClassificationHead", "RegressionHead", "SurvivalHead", "MultiTaskHead",
    "cross_entropy_loss", "cox_partial_likelihood", "discrete_survival_loss",
    "GlobalMeanPool", "GlobalMaxPool", "GlobalAttentionPool", "GlobalSet2SetPool",
    "make_pool",
    "create_model", "default_window_policy", "list_presets", "PRESETS",
]
