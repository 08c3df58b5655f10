"""Task orchestration (counterpart of the JAX package's ``quantum/``): the
planner, the scheduler and its safety guard, the hyperparameter search, the
statevector simulator and hybrid layer, task distribution and federated
learning over ``DGDMTrainer`` clients. The names are the reference's; the
implementations are classical schedulers, optimizers and simulators."""

from .distributed import (
    ClusterKV,
    ComputeNode,
    DistributedTask,
    NodeType,
    QuantumDistributedManager,
    TaskDistributionStrategy,
)
from .federated_learning import (
    DPConfig,
    FederatedClient,
    FederatedDGDMManager,
    FederatedServer,
    FederatedStrategy,
)
from .hardware import (
    Circuit,
    GoogleQuantumBackend,
    HybridQuantumClassicalLayer,
    IBMQuantumBackend,
    LocalStatevectorBackend,
    QuantumBackendInterface,
    QuantumConfig,
    QuantumHardwareManager,
    QuantumProvider,
)
from .optimizer import OptimizationSpace, Parameter, QuantumOptimizer, Trial, dgdm_search_space
from .planner import QuantumPlanner, QuantumTaskPlanner, Task, TaskPriority, TaskStatus
from .safety import QuantumSafetyManager, SafeScheduler
from .scheduler import QuantumScheduler, ResourceSnapshot, SchedulingStrategy, read_resources

__all__ = [
    "QuantumSafetyManager", "SafeScheduler",
    "QuantumProvider", "QuantumConfig", "Circuit", "QuantumBackendInterface",
    "LocalStatevectorBackend", "IBMQuantumBackend", "GoogleQuantumBackend",
    "QuantumHardwareManager", "HybridQuantumClassicalLayer",
    "NodeType", "TaskDistributionStrategy", "ComputeNode", "DistributedTask",
    "ClusterKV", "QuantumDistributedManager",
    "QuantumTaskPlanner", "QuantumPlanner", "Task", "TaskPriority", "TaskStatus",
    "QuantumScheduler", "SchedulingStrategy", "ResourceSnapshot", "read_resources",
    "QuantumOptimizer", "OptimizationSpace", "Parameter", "Trial", "dgdm_search_space",
    "FederatedClient", "FederatedServer", "FederatedStrategy", "FederatedDGDMManager",
    "DPConfig",
]
