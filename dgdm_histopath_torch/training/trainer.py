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
global generator. ``state_dict()`` holds what a resume needs (parameters,
AdamW state, ``step``, ``seed``, ``current_epoch``); ``fit`` checkpoints
through a ``CheckpointManager`` and stops at a step boundary when its
``PreemptionGuard`` trips.

``fit`` feeds the steps through a ``PrefetchIterator``: a background thread
takes the loader's next batch, copies it to pinned host memory and starts
its upload on a side stream while the current step runs; the step's stream
waits for that upload's event.

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
from ..nn.layers import init_parameters
from ..ops.graph import PaddedGraph, band_eligible, in_band_fraction
from ..utils.config import DGDMConfig
from ..utils.device import resolve_device
from ..utils.monitoring import monitor_operation
from ..utils.optimization import PrefetchIterator
from .losses import contrastive_loss
from .preemption import skip_batches

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
    # read by the MoE block, which the model does not build yet; held so that
    # a JAX trainer config carries over
    moe_aux_weight: float = 0.01
    # the way past the band guard: training a graph_window model on graphs
    # whose edges are not all in-band drops the out-of-band edges, and
    # init_state raises on such an example batch unless this is set
    allow_out_of_band_graphs: bool = False

    @classmethod
    def from_config(cls, cfg: DGDMConfig) -> "TrainerConfig":
        t, a = cfg.training, cfg.advanced
        return cls(
            learning_rate=t.learning_rate, weight_decay=t.weight_decay,
            max_epochs=t.max_epochs, pretrain_epochs=t.pretrain_epochs,
            masking_ratio=t.masking_ratio, use_contrastive_loss=t.use_contrastive_loss,
            contrastive_temperature=t.contrastive_temperature,
            scheduler_type=t.scheduler_type, warmup_steps=t.warmup_steps,
            gradient_clip_val=a.gradient_clip_val,
            accumulate_grad_batches=a.accumulate_grad_batches,
            allow_out_of_band_graphs=t.allow_out_of_band_graphs)


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
        self._upload_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                               else None)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, example_batch: Optional[PaddedGraph] = None) -> None:
        """Start a run at step 0: a fresh optimizer state over the model's
        parameters as they are (``create_model`` drew them from its seed, a
        converted bundle brings its own) and ``seed`` for the steps' draws.

        ``example_batch`` is held to the band guard: a ``graph_window`` model
        on a batch with under 99% of its edges in-band raises ``ValueError``
        (or warns, with ``allow_out_of_band_graphs``)."""
        if example_batch is not None:
            self._check_band(example_batch)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.config, self.params)
        self.seed, self.step = int(seed), 0
        n_params = sum(p.numel() for p in self.params)
        logger.info("training %.2fM parameters on %s", n_params / 1e6, self.device)

    def _check_band(self, batch: PaddedGraph) -> None:
        gw = self.model.graph_window
        if not gw or not band_eligible(batch.num_nodes, gw):
            return
        frac = in_band_fraction(batch.nbr_idx, batch.nbr_mask, gw)
        if frac >= 0.99:
            return
        msg = (f"graph_window={gw} but only {100 * frac:.1f}% of edges are in-band — "
               f"banded message passing drops the rest. Build graphs in spatial-sort "
               f"(Morton) order with neighbors limited to the ±1-block band "
               f"(knn_window={gw}) for exact banded compute.")
        if not self.config.allow_out_of_band_graphs:
            raise ValueError(msg + " Set TrainerConfig(allow_out_of_band_graphs=True) to "
                             "train on them anyway.")
        logger.warning("%s Proceeding anyway (allow_out_of_band_graphs=True).", msg)

    def state_dict(self) -> Dict[str, Any]:
        """What a resume needs: the model's parameters, the AdamW state,
        ``step``, ``seed`` and ``current_epoch`` (tensors on the device)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "seed": self.seed, "current_epoch": self.current_epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Take up a ``state_dict()`` (from this device or another)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.seed = int(state["step"]), int(state["seed"])
        self.current_epoch = int(state["current_epoch"])

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

        metrics["grad_norm"] = norm
        # in key order, as the reference's jitted step returns them
        metrics = {k: metrics[k].detach() for k in sorted(metrics)}
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

    def _prepare_batch(self, batch: PaddedGraph):
        """(batch on the device, its upload's event or None). On the card a
        host batch is copied to pinned memory and uploaded on the side
        stream; called on the prefetch thread."""
        if self._upload_stream is None or batch.x.is_cuda:
            return batch.to(self.device), None
        pinned = batch.pin_memory()
        with torch.cuda.stream(self._upload_stream):
            on_card = pinned.to(self.device, non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record()
        return on_card, uploaded

    def _await_upload(self, prepared) -> PaddedGraph:
        """Make the current stream wait for the batch's upload, and keep its
        memory from reuse until the work queued on this stream is done."""
        batch, uploaded = prepared
        if uploaded is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(uploaded)
            for t in batch.tensors():
                t.record_stream(stream)
        return batch

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            max_epochs: Optional[int] = None, checkpoint_manager=None,
            log_every: int = 50, early_stopping_patience: int = 10, train_logger=None,
            preemption_guard=None, start_step_in_epoch: int = 0,
            restore_best_params: bool = False) -> Dict[str, Any]:
        """Epoch loop with the two-phase curriculum, validation, checkpoints
        and early stopping (finetune phase only).

        ``checkpoint_manager``: a ``CheckpointManager``; after each validated
        epoch it saves ``state_dict()`` at step ``epoch`` with ``val_loss``.
        ``train_logger``: a ``TrainLogger`` that receives every epoch summary.
        ``restore_best_params`` keeps a host copy of the parameters at the
        best validation loss and loads it back when the loop ends.

        ``preemption_guard``: a ``PreemptionGuard``; when it trips, the loop
        stops at the next step boundary, saves an emergency checkpoint with
        ``extra={"resume": {"epoch", "step_in_epoch", "mid_epoch"}}`` and
        returns ``{"interrupted": True, "resume": {...}}``.
        ``start_step_in_epoch`` skips that many batches of the first epoch
        (a resume): with a deterministic loader the replay is bit-identical.
        """
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        max_epochs = max_epochs or self.config.max_epochs
        best_val, best_params, patience = float("inf"), None, 0
        first_epoch = self.current_epoch
        interrupted = False
        resume_info: Dict[str, Any] = {}
        for epoch in range(self.current_epoch, max_epochs):
            self.current_epoch = epoch
            phase = self.phase_for_epoch(epoch)
            totals: Dict[str, torch.Tensor] = {}
            t0 = time.perf_counter()
            skip = start_step_in_epoch if epoch == first_epoch else 0
            # n_steps is the position in the epoch, counting the skipped batches
            n_steps = skip
            epoch_loader = skip_batches(train_loader, skip) if skip else train_loader
            with monitor_operation(f"train_epoch_{phase}"):
                prepared = PrefetchIterator((self._prepare_batch(b) for b in epoch_loader),
                                            depth=2)
                for item in prepared:
                    # accumulated on the device: one host sync per epoch
                    m = self.training_step(self._await_upload(item), epoch,
                                           materialize=False)
                    n_steps += 1
                    for k, v in m.items():
                        totals[k] = v if k not in totals else totals[k] + v
                    if n_steps % log_every == 0:
                        logger.info("epoch %d [%s] step %d loss=%.4f", epoch, phase,
                                    n_steps, float(m["loss"]))
                    if preemption_guard is not None and preemption_guard.triggered:
                        interrupted = True
                        prepared.close()
                        break
            if interrupted:
                resume_info = {"epoch": epoch, "step_in_epoch": n_steps, "mid_epoch": True}
                logger.warning("preemption: stopping at epoch %d step %d", epoch, n_steps)
                if checkpoint_manager is not None:
                    checkpoint_manager.save(self.state_dict(), step=epoch,
                                            extra={"resume": resume_info})
                break
            summary: Dict[str, Any] = {f"train_{k}": float(v) / max(n_steps - skip, 1)
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
                if checkpoint_manager is not None:
                    checkpoint_manager.save(self.state_dict(), step=epoch,
                                            metric=summary["val_loss"])
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
                        if train_logger is not None:
                            train_logger.log_metrics(summary, step=epoch)
                        break
            self.history.append(summary)
            if train_logger is not None:
                train_logger.log_metrics(summary, step=epoch)
            logger.info("epoch %d done: %s", epoch,
                        {k: round(v, 4) for k, v in summary.items() if isinstance(v, float)})
        if checkpoint_manager is not None:
            # saves run in the background: the last one is on disk when fit returns
            checkpoint_manager.wait_until_finished()
        if restore_best_params and best_params is not None and not interrupted:
            self.model.load_state_dict(best_params)
        result: Dict[str, Any] = {"history": self.history, "best_val_loss": best_val,
                                  "interrupted": interrupted}
        if interrupted:
            result["resume"] = resume_info
        return result

    @torch.no_grad()
    def predict_step(self, batch: PaddedGraph, return_attention: bool = True
                     ) -> Dict[str, Any]:
        return self.model(batch.to(self.device), mode="inference", deterministic=True,
                          return_attention=return_attention)

    def generate_embeddings(self, loader: Iterable) -> np.ndarray:
        embs = [self.model.generate_embeddings(batch.to(self.device)).float().cpu().numpy()
                for batch in loader]
        return np.concatenate(embs, axis=0)

    @classmethod
    def from_config(cls, cfg: DGDMConfig, mesh=None, device=None) -> "DGDMTrainer":
        """A trainer over a ``DGDMModel`` built from ``cfg.model`` (the
        classification / regression / survival sections switch their heads
        on), its parameters drawn from ``cfg.experiment.seed``. A mesh
        (``mesh`` or ``hardware.mesh_shape``) and ``moe_experts`` raise
        naming ROADMAP item 12, a ``param_dtype`` other than float32 item 8."""
        if mesh is not None or cfg.hardware.mesh_shape:
            raise NotImplementedError(_NOT_PORTED.format(what="training on a mesh", item=12))
        m = cfg.model
        model = DGDMModel(
            node_features=m.node_features, hidden_dims=tuple(m.hidden_dims),
            num_diffusion_steps=m.num_diffusion_steps, attention_heads=m.attention_heads,
            dropout=m.dropout, graph_layers=m.graph_layers,
            use_spatial_attention=m.use_spatial_attention,
            use_hierarchical=m.use_hierarchical, diffusion_schedule=m.diffusion_schedule,
            activation=m.activation, normalization=m.normalization, pooling=m.pooling,
            num_classes=(cfg.classification.num_classes if cfg.classification.enabled
                         else m.num_classes),
            regression_targets=(cfg.regression.num_targets if cfg.regression.enabled
                                else m.regression_targets),
            survival_mode=cfg.survival.mode if cfg.survival.enabled else None,
            survival_intervals=cfg.survival.num_intervals, edge_features=m.edge_features,
            compute_dtype=m.compute_dtype, param_dtype=m.param_dtype,
            attention_traffic_dtype=m.attention_traffic_dtype,
            spatial_window=m.spatial_window, graph_window=m.graph_window,
            moe_experts=m.moe_experts, moe_top_k=m.moe_top_k, moe_capacity=m.moe_capacity)
        init_parameters(model, torch.Generator().manual_seed(cfg.experiment.seed))
        return cls(model, TrainerConfig.from_config(cfg), device=device)
