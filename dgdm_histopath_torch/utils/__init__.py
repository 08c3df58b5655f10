"""Cross-cutting utilities: logging, config, validation, monitoring, errors
(the JAX package's ``utils`` exports, from the port's modules)."""

from .config import (
    DataConfig,
    DGDMConfig,
    HardwareConfig,
    ModelConfig,
    TrainingConfig,
    config_from_dict,
    config_to_dict,
    config_transaction,
    load_config,
    merge_configs,
    save_config,
)
from .exceptions import (
    CheckpointError,
    ConfigurationError,
    DataError,
    DGDMException,
    ExceptionHandler,
    GraphConstructionError,
    InferenceError,
    ModelError,
    ResourceError,
    SecurityError,
    SlideProcessingError,
    TrainingError,
    ValidationError,
    safe_execute,
)
from .logging import get_logger, log_execution_time, setup_logging
from .monitoring import (
    GLOBAL_HEALTH,
    GLOBAL_METRICS,
    HealthChecker,
    MetricsCollector,
    PerformanceMetrics,
    device_memory_stats,
    monitor_operation,
)
from .validation import FileValidator, InputValidator

__all__ = [
    "get_logger", "setup_logging", "log_execution_time",
    "DGDMException", "ConfigurationError", "ValidationError", "DataError",
    "SlideProcessingError", "GraphConstructionError", "ModelError",
    "TrainingError", "CheckpointError", "InferenceError", "ResourceError",
    "SecurityError", "safe_execute", "ExceptionHandler",
    "DGDMConfig", "ModelConfig", "DataConfig", "TrainingConfig", "HardwareConfig",
    "load_config", "save_config", "merge_configs", "config_transaction",
    "config_from_dict", "config_to_dict",
    "InputValidator", "FileValidator",
    "monitor_operation", "MetricsCollector", "GLOBAL_METRICS", "HealthChecker",
    "GLOBAL_HEALTH", "device_memory_stats", "PerformanceMetrics",
]
