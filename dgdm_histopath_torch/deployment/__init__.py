"""Deployment: the inference server, its dynamic batcher, the edge bundle
and program export, and production orchestration (Kubernetes manifests,
autoscaling, staged deploys, the health report)."""

from .batching import DynamicBatcher
from .edge import (
    EdgeConfig, EdgeDeploymentManager, EdgeInferenceEngine, EdgeModelOptimizer,
    EdgeResourceMonitor, cast_params, dequantize_params, quantize_params_int8,
)
from .production import (
    AutoScaler, DeploymentStage, K8sConfig, KubernetesOrchestrator, ProductionHealthChecker,
    ProductionOrchestrator,
)
from .serving import InferenceServer, graph_from_json

__all__ = [
    "EdgeConfig", "EdgeModelOptimizer", "EdgeInferenceEngine",
    "EdgeResourceMonitor", "EdgeDeploymentManager",
    "quantize_params_int8", "dequantize_params", "cast_params",
    "K8sConfig", "KubernetesOrchestrator", "AutoScaler",
    "ProductionOrchestrator", "ProductionHealthChecker", "DeploymentStage",
    "InferenceServer", "graph_from_json", "DynamicBatcher",
]
