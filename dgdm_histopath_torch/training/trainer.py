"""DGDMTrainer: two-phase curriculum training (counterpart of the JAX
package's ``training/trainer.py``).

Epoch-indexed curriculum: pretrain (diffusion + reconstruction + contrastive
losses on entity-masked graphs), then finetune (classification, regression
or survival, with the self-supervised objective as the fallback for
unlabeled batches). AdamW after a global-norm clip, warmup + cosine /
onecycle learning rate with a ×``finetune_lr_factor`` drop at the phase
switch. Losses, gradients at the parameters and the clip norm are f32
whatever the compute dtype.

The update rule is optax's ``chain(clip_by_global_norm, adamw)``: the clip
divides by the norm itself, weight decay falls on every parameter, every
parameter is updated every step (one that the loss does not reach gets a
zero gradient), and the learning rate of update ``i`` is ``schedule(i)``
counted from 0, so with warmup the first update has rate 0.

Randomness: the trainer owns one ``torch.Generator`` on its device and
reseeds it from ``(seed, step)`` at the start of each step, so a run that
resumes at step ``s`` replays the draws of step ``s``. Nothing reads the
global generator.

The trainer runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..evaluation.metrics import concordance_index
from ..models.decoders import cox_partial_likelihood, discrete_survival_loss
from ..models.dgdm import DGDMModel
from ..ops.graph import PaddedGraph
from ..utils.device import resolve_device
from .losses import contrastive_loss

logger = logging.getLogger("dgdm_histopath_torch.training")

VALIDATION_STREAM = 999      # the generator stream of validation draws
_NOT_PORTED = ("{what} is not ported yet (ROADMAP queue 1, item {item})")


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    max_epochs: int = 100
    pretrain_epochs: int = 50
    masking_ratio: float = 0.15
    use_contrastive_loss: bool = True
    contrastive_temperature: float = 0.1
    reconstruction_weight: float = 1.0
    scheduler_type: str = "cosine"   # cosine | onecycle | none
    warmup_steps: int = 1000
    gradient_clip_val: float = 1.0
    accumulate_grad_batches: int = 1  # > 1 raises: not ported
    finetune_lr_factor: float = 0.1  # LR drop at the phase switch
    steps_per_epoch: int = 1000      # estimate; the schedule's horizon
    # read by the MoE block and the banded message passing, neither of which
    # the model builds yet; held so that a JAX trainer config carries over
    moe_aux_weight: float = 0.01
    allow_out_of_band_graphs: bool = False


def make_lr_schedule(cfg: TrainerConfig) -> Callable[[int], float]:
    """``step -> learning rate`` (step counted from 0): warmup + cosine,
    onecycle or constant, times ``finetune_lr_factor`` from the first
    finetune step on. The closed forms are optax's
    ``warmup_cosine_decay_schedule`` and ``cosine_onecycle_schedule``."""
    total_steps = max(cfg.max_epochs * cfg.steps_per_epoch, cfg.warmup_steps + 1)
    pretrain_steps = cfg.pretrain_epochs * cfg.steps_per_epoch
    peak, warmup = cfg.learning_rate, cfg.warmup_steps

    if cfg.scheduler_type == "cosine":
        end = peak * 1e-2
        alpha = 0.0 if peak == 0.0 else end / peak
        decay_steps = total_steps - warmup

        def base(step: int) -> float:
            if step < warmup:
                return peak * step / warmup
            count = min(step - warmup, decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
            return peak * ((1.0 - alpha) * cosine + alpha)
    elif cfg.scheduler_type == "onecycle":
        # cosine interpolation peak/25 -> peak over the first 30% of the
        # steps, then peak -> peak/(25·1e4) over the rest
        bounds = (0, int(0.3 * total_steps), int(total_steps))
        values = (peak / 25.0, peak, peak / (25.0 * 1e4))

        def base(step: int) -> float:
            if step >= bounds[-1]:
                return values[-1]
            i = 0 if step < bounds[1] else 1
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            start, stop = values[i], values[i + 1]
            return stop + (start - stop) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    elif cfg.scheduler_type == "none":
        def base(step: int) -> float:
            return peak
    else:
        raise ValueError(f"unknown scheduler_type {cfg.scheduler_type!r}")

    def schedule(step: int) -> float:
        scale = cfg.finetune_lr_factor if step >= pretrain_steps else 1.0
        return base(int(step)) * scale

    return schedule


def make_optimizer(cfg: TrainerConfig, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with decay on every parameter. The
    trainer clips before it and sets the rate from ``make_lr_schedule``
    before every ``step()``."""
    if cfg.accumulate_grad_batches > 1:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"accumulate_grad_batches={cfg.accumulate_grad_batches}", item=12))
    return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _fold(seed: int, stream: int) -> int:
    """One generator seed from (seed, stream)."""
    return (seed * 0x9E3779B1 + stream * 0x85EBCA6B + 0x27D4EB2F) % (2 ** 63)


def _valid_graphs(batch: PaddedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filler graphs (all-padding node_mask) carry zero weight: (valid [B]
    f32, the number of valid graphs, at least 1)."""
    valid = batch.node_mask.any(-1).float()
    return valid, valid.sum().clamp_min(1.0)


class DGDMTrainer:
    """Two-phase DGDM training loop.

    ``task``: ``"classification"`` | ``"regression"`` | ``"survival"`` |
    ``None`` (self-supervised only); by default read off the model's heads.
    ``device=None`` means ``"cuda"`` and raises when no card is present.
    """

    def __init__(self, model: DGDMModel, config: Optional[TrainerConfig] = None,
                 task: Optional[str] = None, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED.format(what="training on a mesh", item=12))
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config or TrainerConfig()
        self.task = task or (
            "classification" if model.num_classes else
            ("regression" if model.regression_targets else
             ("survival" if model.survival_mode else None)))
        self.lr_schedule = make_lr_schedule(self.config)
        self.optimizer: Optional[torch.optim.AdamW] = None
        self.params: list[torch.nn.Parameter] = []
        self.generator = torch.Generator(device=self.device)
        self.seed = 0
        self.step = 0
        self.history: list[Dict[str, Any]] = []
        self.current_epoch = 0

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> None:
        """Start a run at step 0: a fresh optimizer state over the model's
        parameters as they are (``create_model`` drew them from its seed, a
        converted bundle brings its own) and ``seed`` for the steps' draws."""
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.config, self.params)
        self.seed, self.step = int(seed), 0
        n_params = sum(p.numel() for p in self.params)
        logger.info("training %.2fM parameters on %s", n_params / 1e6, self.device)

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------
    def _pretrain_losses(self, batch: PaddedGraph, draws: Optional[Dict[str, torch.Tensor]]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        draws = draws or {}
        cfg = self.config
        out = self.model.pretrain_step(
            batch, mask_ratio=cfg.masking_ratio, deterministic=False,
            generator=self.generator, masked=draws.get("masked"), t=draws.get("t"),
            noise=draws.get("noise"))
        metrics = {"diffusion_loss": out["diffusion_loss"],
                   "reconstruction_loss": out["reconstruction_loss"]}
        loss = out["diffusion_loss"] + cfg.reconstruction_weight * out["reconstruction_loss"]
        if cfg.use_contrastive_loss:
            closs = contrastive_loss(out["node_embeddings"], batch.node_mask,
                                     cfg.contrastive_temperature,
                                     uniform=draws.get("uniform"), generator=self.generator)
            metrics["contrastive_loss"] = closs
            loss = loss + closs
        metrics["loss"] = loss
        return loss, metrics

    def _finetune_losses(self, batch: PaddedGraph, draws: Optional[Dict[str, torch.Tensor]]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if batch.y is None:
            # unlabeled fallback: keep optimizing the self-supervised objective
            return self._pretrain_losses(batch, draws)
        out = self.model(batch, mode="finetune", deterministic=False,
                         generator=self.generator)
        valid, denom = _valid_graphs(batch)
        if self.task == "classification":
            logits = out["classification_logits"].float()
            labels = batch.y.long()
            per = F.cross_entropy(logits, labels, reduction="none")
            loss = (per * valid).sum() / denom
            acc = ((logits.argmax(-1) == labels).float() * valid).sum() / denom
            return loss, {"loss": loss, "accuracy": acc}
        if self.task == "regression":
            pred = out["regression"]["mean"].float()
            per = ((pred - batch.y.float().reshape(pred.shape)) ** 2).mean(-1)
            loss = (per * valid).sum() / denom
            return loss, {"loss": loss, "mse": loss}
        if self.task == "survival":
            loss = self._survival_loss(out["survival"], batch, valid)
            return loss, {"loss": loss, "survival_loss": loss}
        raise ValueError(f"finetune requires a task; got {self.task!r}")

    def _survival_loss(self, surv: Dict[str, torch.Tensor], batch: PaddedGraph,
                       valid: torch.Tensor) -> torch.Tensor:
        """batch.y carries (time, event) pairs: [B, 2]."""
        time_, event = batch.y[..., 0].float(), batch.y[..., 1].float()
        if self.model.survival_mode == "cox":
            return cox_partial_likelihood(surv["risk"], time_, event, valid=valid)
        return discrete_survival_loss(surv["hazard_logits"], time_.long(), event, valid=valid)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def phase_for_epoch(self, epoch: int) -> str:
        return "pretrain" if epoch < self.config.pretrain_epochs else "finetune"

    def training_step(self, batch: PaddedGraph, epoch: Optional[int] = None,
                      materialize: bool = True,
                      draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
        """One optimization step; returns the phase's scalar metrics and
        ``grad_norm`` (the global norm before clipping).

        ``materialize=False`` returns 0-d tensors on the device without a
        host sync. ``draws`` may hold the pretrain draws ``masked`` [B, N]
        bool, ``t`` [B], ``noise`` [B, N, hidden] and ``uniform`` [B, N]
        (the contrastive subsample scores) in place of the generator's.
        """
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        epoch = self.current_epoch if epoch is None else epoch
        loss_fn = (self._pretrain_losses if self.phase_for_epoch(epoch) == "pretrain"
                   else self._finetune_losses)
        batch = batch.to(self.device)
        self.generator.manual_seed(_fold(self.seed, self.step))

        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, draws)
        loss.float().backward()
        for p in self.params:               # unreached parameters still decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        max_norm = self.config.gradient_clip_val
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = norm
        if materialize:
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            return dict(zip(metrics, values))
        return metrics

    @torch.no_grad()
    def validation_step(self, batch: PaddedGraph, epoch: Optional[int] = None,
                        draws: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """Deterministic evaluation of one batch (tensors on the device).
        Pretrain phase or no labels: ``loss`` = diffusion + reconstruction,
        its draws taken from the validation stream of the seed."""
        epoch = self.current_epoch if epoch is None else epoch
        batch = batch.to(self.device)
        if self.phase_for_epoch(epoch) == "pretrain" or batch.y is None:
            draws = draws or {}
            self.generator.manual_seed(_fold(self.seed, VALIDATION_STREAM))
            out = self.model.pretrain_step(
                batch, mask_ratio=self.config.masking_ratio, deterministic=True,
                generator=self.generator, masked=draws.get("masked"), t=draws.get("t"),
                noise=draws.get("noise"))
            return {"loss": out["diffusion_loss"] + out["reconstruction_loss"]}
        out = self.model(batch, mode="inference", deterministic=True)
        valid, denom = _valid_graphs(batch)
        if self.task == "classification":
            logits = out["classification_logits"].float()
            labels = batch.y.long()
            per = F.cross_entropy(logits, labels, reduction="none")
            correct = (logits.argmax(-1) == labels).float()
            return {"loss": (per * valid).sum() / denom,
                    "accuracy": (correct * valid).sum() / denom, "valid": valid,
                    "probabilities": torch.softmax(logits, -1)}
        if self.task == "survival":
            surv = out["survival"]
            loss = self._survival_loss(surv, batch, valid)
            risk = (surv["risk"].float() if self.model.survival_mode == "cox"
                    else -surv["survival"].sum(-1))   # -E[survival time] proxy
            return {"loss": loss, "valid": valid, "risk": risk,
                    "time": batch.y[..., 0].float(), "event": batch.y[..., 1].float()}
        pred = out["regression"]["mean"].float()
        per = ((pred - batch.y.float().reshape(pred.shape)) ** 2).mean(-1)
        return {"loss": (per * valid).sum() / denom, "valid": valid}

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            max_epochs: Optional[int] = None, checkpoint_manager=None,
            log_every: int = 50, early_stopping_patience: int = 10, train_logger=None,
            preemption_guard=None, start_step_in_epoch: int = 0,
            restore_best_params: bool = False) -> Dict[str, Any]:
        """Epoch loop with the two-phase curriculum, validation and early
        stopping (finetune phase only). ``restore_best_params`` keeps a host
        copy of the parameters at the best validation loss and loads it back
        when the loop ends. Checkpointing, the train logger, the preemption
        guard and resuming inside an epoch are not ported."""
        for what, given in (("fit(checkpoint_manager=...)", checkpoint_manager is not None),
                            ("fit(train_logger=...)", train_logger is not None),
                            ("fit(preemption_guard=...)", preemption_guard is not None),
                            ("fit(start_step_in_epoch=...)", start_step_in_epoch != 0)):
            if given:
                raise NotImplementedError(_NOT_PORTED.format(what=what, item=11))
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        max_epochs = max_epochs or self.config.max_epochs
        best_val, best_params, patience = float("inf"), None, 0
        for epoch in range(self.current_epoch, max_epochs):
            self.current_epoch = epoch
            phase = self.phase_for_epoch(epoch)
            totals: Dict[str, torch.Tensor] = {}
            t0 = time.perf_counter()
            n_steps = 0
            for batch in train_loader:
                # accumulated on the device: one host sync per epoch
                m = self.training_step(batch, epoch, materialize=False)
                n_steps += 1
                for k, v in m.items():
                    totals[k] = v if k not in totals else totals[k] + v
                if n_steps % log_every == 0:
                    logger.info("epoch %d [%s] step %d loss=%.4f", epoch, phase, n_steps,
                                float(m["loss"]))
            summary: Dict[str, Any] = {f"train_{k}": float(v) / max(n_steps, 1)
                                       for k, v in totals.items()}
            summary.update(epoch=epoch, phase=phase,
                           epoch_time_s=time.perf_counter() - t0, steps=n_steps)

            if val_loader is not None:
                outs = [self.validation_step(batch, epoch) for batch in val_loader]
                summary["val_loss"] = (float(sum(o["loss"] for o in outs)) / len(outs)
                                       if outs else float("nan"))
                accs = [o["accuracy"] for o in outs if "accuracy" in o]
                if accs:
                    summary["val_accuracy"] = float(sum(accs)) / len(accs)
                surv = [o for o in outs if "risk" in o]
                if surv:
                    def cat(key):
                        return torch.cat([o[key] for o in surv]).cpu().numpy()
                    v = cat("valid") > 0
                    summary["val_cindex"] = concordance_index(
                        cat("time")[v], cat("risk")[v], cat("event")[v])
                if summary["val_loss"] < best_val - 1e-6:
                    best_val, patience = summary["val_loss"], 0
                    if restore_best_params:
                        best_params = {k: v.detach().cpu().clone()
                                       for k, v in self.model.state_dict().items()}
                else:
                    patience += 1
                    if patience >= early_stopping_patience and phase == "finetune":
                        logger.info("early stopping at epoch %d", epoch)
                        self.history.append(summary)
                        break
            self.history.append(summary)
            logger.info("epoch %d done: %s", epoch,
                        {k: round(v, 4) for k, v in summary.items() if isinstance(v, float)})
        if restore_best_params and best_params is not None:
            self.model.load_state_dict(best_params)
        return {"history": self.history, "best_val_loss": best_val, "interrupted": False}

    @torch.no_grad()
    def predict_step(self, batch: PaddedGraph, return_attention: bool = True
                     ) -> Dict[str, Any]:
        return self.model(batch.to(self.device), mode="inference", deterministic=True,
                          return_attention=return_attention)

    def generate_embeddings(self, loader: Iterable) -> np.ndarray:
        embs = [self.model.generate_embeddings(batch.to(self.device)).float().cpu().numpy()
                for batch in loader]
        return np.concatenate(embs, axis=0)
