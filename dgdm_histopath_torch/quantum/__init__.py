"""Task orchestration layer (counterpart of the JAX package's ``quantum/``).
Ported so far: federated learning over ``DGDMTrainer`` clients. The
planner, scheduler, optimizer, safety, hardware and distributed modules
are still to port (ROADMAP queue 1)."""

from .federated_learning import (
    DPConfig,
    FederatedClient,
    FederatedDGDMManager,
    FederatedServer,
    FederatedStrategy,
)

__all__ = ["FederatedClient", "FederatedServer", "FederatedStrategy",
           "FederatedDGDMManager", "DPConfig"]
