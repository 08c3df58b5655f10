"""Deployment: the inference server, its dynamic batcher, its health report
and the edge bundle."""

from .batching import DynamicBatcher
from .edge import (
    EdgeConfig, EdgeDeploymentManager, EdgeInferenceEngine, EdgeModelOptimizer,
    EdgeResourceMonitor, cast_params, dequantize_params, quantize_params_int8,
)
from .production import ProductionHealthChecker
from .serving import InferenceServer, graph_from_json

__all__ = [
    "EdgeConfig", "EdgeModelOptimizer", "EdgeInferenceEngine",
    "EdgeResourceMonitor", "EdgeDeploymentManager",
    "quantize_params_int8", "dequantize_params", "cast_params",
    "ProductionHealthChecker", "InferenceServer", "graph_from_json", "DynamicBatcher",
]
