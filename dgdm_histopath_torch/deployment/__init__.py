"""Deployment: the inference server, its dynamic batcher and its health
report."""

from .batching import DynamicBatcher
from .production import ProductionHealthChecker
from .serving import InferenceServer, graph_from_json

__all__ = ["ProductionHealthChecker", "InferenceServer", "graph_from_json", "DynamicBatcher"]
