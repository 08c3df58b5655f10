"""Evaluation: the predictor, metrics and the attention visualizer."""

from .metrics import (
    bootstrap_ci,
    compute_classification_metrics,
    compute_clinical_metrics,
    compute_graph_statistics,
    compute_regression_metrics,
    compute_segmentation_metrics,
    concordance_index,
    dice_score,
    expected_grade_decode,
    iou_score,
    paired_bootstrap_delta,
    pooled_paired_bootstrap_delta,
    quadratic_weighted_kappa,
)
from .predictor import DGDMPredictor, load_model_checkpoint
from .visualizer import AttentionVisualizer

__all__ = [
    "DGDMPredictor", "load_model_checkpoint", "AttentionVisualizer",
    "compute_classification_metrics", "compute_regression_metrics",
    "compute_segmentation_metrics", "compute_graph_statistics",
    "quadratic_weighted_kappa", "expected_grade_decode",
    "compute_clinical_metrics", "concordance_index", "dice_score", "iou_score",
    "bootstrap_ci", "paired_bootstrap_delta", "pooled_paired_bootstrap_delta",
]
