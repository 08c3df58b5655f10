"""Federated learning simulation over the port's parameter dicts
(counterpart of the JAX package's ``quantum/federated_learning.py``):
FedAvg, FedProx, SCAFFOLD and the "quantum" sqrt-sample weighting, client
sampling, client-side differential privacy (clip to a global norm, then
Gaussian noise), and ``FederatedDGDMManager``, whose clients run real
``DGDMTrainer`` steps.

A parameter tree is a dict of name -> tensor (``model.named_parameters()``'s
names, as ``convert.py`` uses them). The server sums the weighted client
updates in f64 and rounds the new global parameters once; the JAX package
sums them in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger("federated")

Tree = Dict[str, torch.Tensor]


class FederatedStrategy(Enum):
    FEDAVG = "fedavg"
    FEDPROX = "fedprox"
    SCAFFOLD = "scaffold"
    QUANTUM_FED = "quantum_fed"   # weighted FedAvg with sqrt-sample weights


def tree_zeros_like(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_add(a: Tree, b: Tree, scale: float = 1.0) -> Tree:
    return {k: a[k] + scale * b[k] for k in a}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: Tree, s) -> Tree:
    return {k: v * s for k, v in a.items()}


def tree_global_norm(tree: Tree) -> torch.Tensor:
    """The f32 global L2 norm over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(v.float())) for v in tree.values()))


@dataclass
class DPConfig:
    """Client-side differential privacy: clip + Gaussian noise."""
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0

    def privatize(self, update: Tree, generator: torch.Generator) -> Tree:
        """``update`` scaled to a global norm of at most ``clip_norm``, plus
        noise of standard deviation ``noise_multiplier * clip_norm``: one
        normal tensor a leaf, drawn from ``generator`` in the tree's order."""
        norm = tree_global_norm(update)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = tree_scale(update, scale)
        if self.noise_multiplier <= 0:
            return clipped
        sigma = self.noise_multiplier * self.clip_norm
        return {k: v + sigma * torch.randn(v.shape, generator=generator, device=v.device,
                                           dtype=v.dtype)
                for k, v in clipped.items()}


class FederatedClient:
    """One simulated site: local data + a local-update function."""

    def __init__(self, client_id: str, local_update_fn: Callable[[Tree, int], Tree],
                 num_samples: int, dp: Optional[DPConfig] = None):
        """``local_update_fn(global_params, round) -> new_local_params``."""
        self.client_id = client_id
        self.local_update_fn = local_update_fn
        self.num_samples = num_samples
        self.dp = dp
        self.control: Optional[Tree] = None      # SCAFFOLD client control variate

    def compute_update(self, global_params: Tree, round_idx: int,
                       generator: torch.Generator) -> Tree:
        new_params = self.local_update_fn(global_params, round_idx)
        update = tree_sub(new_params, global_params)
        if self.dp is not None:
            update = self.dp.privatize(update, generator)
        return update


class FederatedServer:
    """Round orchestration and strategy aggregation. Noise draws come from
    a ``torch.Generator`` seeded with ``seed`` on the parameters' device;
    client sampling from ``np.random.RandomState(seed)``, as in the JAX
    package, so that both pick the same clients."""

    def __init__(self, global_params: Tree, strategy: FederatedStrategy | str = "fedavg",
                 clients_per_round: Optional[int] = None, fedprox_mu: float = 0.01,
                 server_lr: float = 1.0, seed: int = 0):
        if isinstance(strategy, str):
            strategy = FederatedStrategy(strategy)
        self.global_params = global_params
        self.strategy = strategy
        self.clients_per_round = clients_per_round
        self.fedprox_mu = fedprox_mu
        self.server_lr = server_lr
        self.clients: List[FederatedClient] = []
        self.server_control: Optional[Tree] = None
        self.history: List[Dict[str, float]] = []
        device = next(iter(global_params.values())).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._select_rng = np.random.RandomState(seed)

    def register_client(self, client: FederatedClient) -> None:
        self.clients.append(client)
        if self.strategy == FederatedStrategy.SCAFFOLD and client.control is None:
            client.control = tree_zeros_like(self.global_params)

    def select_clients(self, round_idx: int) -> List[FederatedClient]:
        """Uniform sampling without replacement."""
        k = min(self.clients_per_round or len(self.clients), len(self.clients))
        idx = self._select_rng.choice(len(self.clients), k, replace=False)
        return [self.clients[i] for i in idx]

    def run_round(self, round_idx: int) -> Dict[str, float]:
        selected = self.select_clients(round_idx)
        if not selected:
            raise ValueError("no clients registered")
        if self.server_control is None and self.strategy == FederatedStrategy.SCAFFOLD:
            self.server_control = tree_zeros_like(self.global_params)

        updates, weights = [], []
        for client in selected:
            update = client.compute_update(self.global_params, round_idx, self.generator)
            if self.strategy == FederatedStrategy.SCAFFOLD:
                # drift correction: subtract (c_i - c) from the update,
                # refresh the client control variate
                update = tree_sub(update, tree_sub(client.control, self.server_control))
                client.control = tree_add(client.control, update,
                                          scale=1.0 / max(len(selected), 1))
            updates.append(update)
            weights.append(float(client.num_samples))

        if self.strategy == FederatedStrategy.QUANTUM_FED:
            weights = [math.sqrt(w) for w in weights]
        total = sum(weights)
        agg64 = {k: sum((w / total) * u[k].double() for u, w in zip(updates, weights))
                 for k in self.global_params}
        if self.strategy == FederatedStrategy.FEDPROX:
            # proximal damping of the aggregate step
            agg64 = tree_scale(agg64, 1.0 / (1.0 + self.fedprox_mu))
        agg = {k: v.to(self.global_params[k].dtype) for k, v in agg64.items()}
        if self.strategy == FederatedStrategy.SCAFFOLD:
            self.server_control = tree_add(self.server_control, agg,
                                           scale=len(selected) / max(len(self.clients), 1))
        self.global_params = {k: (p.double() + self.server_lr * agg64[k]).to(p.dtype)
                              for k, p in self.global_params.items()}
        stats = {"round": round_idx, "clients": len(selected),
                 "update_norm": float(tree_global_norm(agg))}
        self.history.append(stats)
        return stats

    def run(self, num_rounds: int,
            eval_fn: Optional[Callable[[Tree], Dict[str, float]]] = None
            ) -> List[Dict[str, float]]:
        for r in range(num_rounds):
            stats = self.run_round(r)
            if eval_fn is not None:
                stats.update({f"eval_{k}": v for k, v in eval_fn(self.global_params).items()})
                self.history[-1] = stats
            logger.info("federated round %d: %s", r, stats)
        return self.history


class FederatedDGDMManager:
    """Federates ``DGDMTrainer``s over data shards: one trainer a client
    (``trainer_factory()``, initialized), ``local_steps`` steps a round on
    batches of its loader (restarted when it runs out).

    The global parameters are a copy of the first trainer's. Each round
    copies them into a client's live parameters before its steps; the
    client keeps its AdamW moments and ``step`` from round to round."""

    def __init__(self, trainer_factory: Callable[[], Any], client_loaders: Dict[str, Any],
                 local_steps: int = 4, strategy: FederatedStrategy | str = "fedavg",
                 dp: Optional[DPConfig] = None, seed: int = 0):
        self.trainers = {cid: trainer_factory() for cid in client_loaders}
        self.client_loaders = client_loaders
        self.local_steps = local_steps
        base_trainer = next(iter(self.trainers.values()))
        if base_trainer.optimizer is None:
            raise ValueError("trainer_factory must return initialized trainers")
        self.server = FederatedServer(
            {k: p.detach().clone() for k, p in base_trainer.model.named_parameters()},
            strategy=strategy, seed=seed)
        for cid, trainer in self.trainers.items():
            self.server.register_client(FederatedClient(
                cid, self._local_update(trainer, client_loaders[cid]),
                num_samples=len(client_loaders[cid]), dp=dp))

    def _local_update(self, trainer, loader) -> Callable[[Tree, int], Tree]:
        def local_update(global_params: Tree, round_idx: int) -> Tree:
            with torch.no_grad():
                for k, p in trainer.model.named_parameters():
                    p.copy_(global_params[k])
            it = iter(loader)
            for _ in range(self.local_steps):
                try:
                    batch = next(it)
                except StopIteration:
                    it = iter(loader)
                    batch = next(it)
                trainer.training_step(batch, epoch=0)
            return {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
        return local_update

    def run(self, num_rounds: int, eval_fn=None) -> List[Dict[str, float]]:
        return self.server.run(num_rounds, eval_fn)

    @property
    def global_params(self) -> Tree:
        return self.server.global_params
