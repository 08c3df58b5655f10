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
counted from 0, so with warmup the first update has rate 0. With
``accumulate_grad_batches = k > 1`` it is ``optax.MultiSteps``: each call
folds its gradient into a running mean, ``acc += (g - acc) / (mini + 1)``,
and every k-th call clips and applies ``acc``; the parameters do not move
in between, and the rate is indexed by applied updates, not by calls.

Parameters below f32 (``param_dtype`` bfloat16 or float16) take optax's
own order instead (:class:`OptaxAdamW`): ``scale_by_adam`` with the moments
in the parameter's dtype, then ``add_decayed_weights``, then the schedule's
``-lr`` cast to that dtype, then ``apply_updates``, each operation rounding
in that dtype; the clip's global norm is optax's, each leaf's sum of
squares rounded to its dtype and the leaves added in flax's path order. The
f32 path above is unchanged. In f16, optax's ``eps`` of 1e-8 is 0: an
element whose second moment is 0 (a zero gradient, or one whose square
underflows) divides by 0, so after the first update every leaf holds NaN,
in the reference as here.

Data parallelism (``mesh`` with a ``data`` axis over a process group): each
rank holds the whole model and takes its block of rows of every global
batch (filled up to a multiple of the ranks with filler graphs). A node (a
block of ``LOCAL_WORLD_SIZE`` ranks, all of them by default) loads its own
training batches and its ranks split each one, so the global batch is the
nodes' batches stacked in node order; over several nodes the ranks first
agree on one shape for their rows (``align_node_batches``), and a node whose
loader runs out early stands in filler graphs until the last one's has.
Validation batches are the same on every rank and split over all of them.
Every batch-mean loss divides by the count over the global batch; InfoNCE takes
its negatives from the global batch and the finetune heads' losses are
taken over the global batch, through a gather with a gradient. Gradients
and metrics are summed over the ranks by one all-reduce before the clip, so
a step over W ranks equals the single-process step on the global batch.
The draws (entity mask, diffusion ``t`` and noise, the contrastive
subsample) are drawn at the global shape from ``(seed, step)`` and sliced;
dropout masks come from a stream of each data rank's own.

Tensor parallelism (a ``model`` axis above 1, ``parallel/tp.py``): the
wide ``Dense`` kernels are laid out as the JAX trainer lays them
(``place_state``): each rank keeps its shards of them and of their AdamW
moments and computes those layers with collectives over its ``model``
line. The ranks of a line take the same rows and draws (the data path
above runs over the ``data`` axis only), so they hold the same loss; the
replicated parameters' gradients are broadcast from the line's first rank,
and the clip's norm counts each sharded leaf's squares once over the line.
``state_dict()`` holds whole tensors, equal to one process's, and
``load_state_dict`` cuts them to this rank's shards again. An axis that is
neither ``data`` nor ``model`` (``expert``, ``pipe``) leaves the parameters
replicated, as the JAX trainer does: its ranks compute replicas.

Node sharding (``training_step(block, epoch, prepared=True, plan=plan)``
over a ``(data, model)`` mesh, ``parallel/sp.py``): each rank trains on its
node block of its data rows, with the whole batch's halo plan. Per-node
losses are the rank's sums over the whole counts (``sp.line_mean``), a
graph-level loss (InfoNCE over the line-gathered embeddings, the heads'
losses on the readout) is shared by the ranks of the line, and the
replicated parameters' gradients and the metrics are summed over the line
by one all-reduce; under a tensor-parallel layout the sharded kernels
compute whole (``tp.whole_weights``) and their gradients come back summed
and cut to the shards before the clip. The draws are the whole graphs'
(cut to the block by ``parallel/sp.py``), so a step equals one process's on
the whole batch, the data-parallel one's under a data axis above 1.

Randomness: the trainer owns one ``torch.Generator`` on its device and
reseeds it from ``(seed, step)`` at the start of each step, so a run that
resumes at step ``s`` replays the draws of step ``s``. Nothing reads the
global generator. ``state_dict()`` holds what a resume needs (parameters,
AdamW state, ``step``, ``seed``, ``current_epoch``); ``fit`` checkpoints
through a ``CheckpointManager`` and stops at a step boundary when its
``PreemptionGuard`` trips.

``fit`` feeds the steps through ``utils.optimization.device_put_prefetch``:
a background thread takes the loader's next batch, copies it to pinned host
memory and starts its upload on a side stream while the current step runs;
the step's stream waits for that upload's event.

The trainer runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..evaluation.metrics import concordance_index
from ..models.decoders import cox_partial_likelihood, discrete_survival_loss
from ..models.dgdm import DGDMModel
from ..nn.layers import init_parameters
from ..nn.moe import local_mean, routing_group
from ..ops.graph import PaddedGraph, band_eligible, in_band_fraction
from ..parallel.mesh import (MODEL_AXIS, Mesh, align_node_batches, all_gather, make_mesh,
                             pad_batch_to_devices, replicate_tree, shard_batch, shard_rows)
from ..parallel.halo import HaloPlan
from ..parallel.sp import line_mean, sp_forward, sp_pretrain_step, whole_node_mask
from ..parallel.tp import (describe_sharding, gather_state, grad_norm, nest, place_state_tp,
                           shard_state, tp_size, unify_replicated)
from ..utils.config import DGDMConfig
from ..utils.device import resolve_device
from ..utils.monitoring import monitor_operation
from ..utils.optimization import device_put_prefetch
from .losses import CONTRASTIVE_NODES, contrastive_loss
from .preemption import skip_batches

logger = logging.getLogger("dgdm_histopath_torch.training")

VALIDATION_STREAM = 999      # the generator stream of validation draws


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
    accumulate_grad_batches: int = 1  # k > 1: optax.MultiSteps(every_k_schedule=k)
    finetune_lr_factor: float = 0.1  # LR drop at the phase switch
    steps_per_epoch: int = 1000      # estimate; the schedule's horizon
    moe_aux_weight: float = 0.01     # the MoE's Switch load-balance loss coefficient
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
                   ) -> torch.optim.Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with decay on every parameter:
    ``torch.optim.AdamW`` over f32 parameters, :class:`OptaxAdamW` where
    any is stored below f32. The trainer clips before it
    (``clip_and_step``) and sets the rate from ``make_lr_schedule`` before
    every ``step()``."""
    if cfg.accumulate_grad_batches < 1:
        raise ValueError(f"accumulate_grad_batches must be >= 1, got "
                         f"{cfg.accumulate_grad_batches}")
    params = list(params)
    opt = (torch.optim.AdamW if all(p.dtype == torch.float32 for p in params)
           else OptaxAdamW)
    return opt(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=cfg.weight_decay)


def in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (exact in f32): a
    multi-tensor op then computes with the constant JAX takes, a Python
    scalar cast to the array's dtype."""
    return torch.tensor(x, dtype=dtype).item()


class OptaxAdamW(torch.optim.Optimizer):
    """optax's ``adamw`` (after its clip) for parameters below f32, step by
    step as optax runs it: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 +
    b2 nu`` in the parameter's dtype, the bias corrections ``1 - b^count``
    in f32 cast to that dtype, ``u = mu_hat / (sqrt(nu_hat) + eps) + wd p``,
    ``p + (-lr) u``; every constant is taken in the parameter's dtype first,
    as JAX takes a Python scalar (so ``eps`` is 0 in f16), and every
    operation rounds in that dtype (multi-tensor ops, one set per dtype).
    The state keeps AdamW's key names (``step``, ``exp_avg``,
    ``exp_avg_sq``)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_dtype: Dict[torch.dtype, list] = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                by_dtype.setdefault(p.dtype, []).append(p)
            for dt, params in by_dtype.items():
                count = np.float32(self.state[params[0]]["step"].item())
                # the bias corrections and -lr in f32, then cast, as optax takes them
                bc1, bc2, neg_lr = (in_dtype(float(x), dt) for x in (
                    1 - np.float32(b1) ** count, 1 - np.float32(b2) ** count,
                    -np.float32(group["lr"])))
                grads = [p.grad for p in params]
                mus = [self.state[p]["exp_avg"] for p in params]
                nus = [self.state[p]["exp_avg_sq"] for p in params]
                torch._foreach_add_(torch._foreach_mul_(mus, in_dtype(b1, dt)),
                                    torch._foreach_mul(grads, in_dtype(1 - b1, dt)))
                sq = torch._foreach_mul(grads, grads)
                torch._foreach_add_(torch._foreach_mul_(nus, in_dtype(b2, dt)),
                                    torch._foreach_mul_(sq, in_dtype(1 - b2, dt)))
                denom = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, in_dtype(group["eps"], dt))
                u = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
                torch._foreach_add_(u, torch._foreach_mul(params, in_dtype(
                    group["weight_decay"], dt)))
                torch._foreach_add_(params, torch._foreach_mul_(u, neg_lr))


def optax_global_norm(grads: list) -> torch.Tensor:
    """optax's ``global_norm`` of ``grads`` (in flax's path order): each
    leaf's sum of squares (the squares rounded to its dtype) accumulated in
    f32 and rounded to its dtype, the leaves added one by one in the
    promoted dtype of the running total and the leaf, the square root in
    the total's dtype. A 0-d tensor on the gradients' device; nothing waits
    for the device."""
    sums = torch._foreach_norm(torch._foreach_mul(grads, grads), 1)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return torch.sqrt(total)


def clip_and_step(params: list, optimizer: torch.optim.Optimizer, lr: float,
                  max_norm: float, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clip the parameters' gradients by their global norm (``norm`` where
    the caller has it) and take one AdamW step at rate ``lr``; returns the
    norm before clipping. Under :class:`OptaxAdamW` the clip is optax's
    ``(g / norm) * max_norm`` in each gradient's dtype."""
    grads = [p.grad for p in params]
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if isinstance(optimizer, OptaxAdamW):
        # select(norm < max_norm, g, (g / norm) * max_norm) on the device:
        # below the limit both factors are 1, and g / 1 * 1 is g exactly
        keep = norm < max_norm
        by_dtype: Dict[torch.dtype, list] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for dt, gs in by_dtype.items():
            torch._foreach_div_(gs, torch.where(keep, 1.0, norm).to(dt))
            torch._foreach_mul_(gs, torch.where(keep, 1.0, in_dtype(max_norm, dt)).to(dt))
    else:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm


def _fold(seed: int, stream: int) -> int:
    """One generator seed from (seed, stream)."""
    return (seed * 0x9E3779B1 + stream * 0x85EBCA6B + 0x27D4EB2F) % (2 ** 63)


class DGDMTrainer:
    """Two-phase DGDM training loop.

    ``task``: ``"classification"`` | ``"regression"`` | ``"survival"`` |
    ``None`` (self-supervised only); by default read off the model's heads.
    ``device=None`` means ``"cuda"`` and raises when no card is present.
    ``mesh``: a ``parallel.Mesh``; by default ``make_mesh()``, which spans
    the initialized process group, or one process when there is none (the
    single-process path). Its ``data`` axis splits the batch, its ``model``
    axis lays the parameters out tensor-parallel.
    """

    def __init__(self, model: DGDMModel, config: Optional[TrainerConfig] = None,
                 task: Optional[str] = None, device=None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config or TrainerConfig()
        self.task = task or (
            "classification" if model.num_classes else
            ("regression" if model.regression_targets else
             ("survival" if model.survival_mode else None)))
        self.mesh = mesh if mesh is not None else make_mesh()
        # the data-parallel path runs wherever the data axis has a group
        self._dp: Optional[Mesh] = self.mesh if self.mesh.group is not None else None
        self._tp = self.mesh.axis(MODEL_AXIS) if tp_size(self.mesh) > 1 else None
        self._sharded: list[bool] = []      # per parameter: a tensor-parallel shard
        self.lr_schedule = make_lr_schedule(self.config)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.params: list[torch.nn.Parameter] = []
        self.generator = torch.Generator(device=self.device)
        # dropout's stream under data parallelism: one of each rank's own
        self.dropout_generator = (torch.Generator(device=self.device) if self._dp
                                  else self.generator)
        self.seed = 0
        self.step = 0
        self.accumulated: list[torch.Tensor] = []    # the running-mean gradient (k > 1)
        self.mini_step = 0
        self.history: list[Dict[str, Any]] = []
        self.current_epoch = 0
        self._moe_group: Optional[int] = None

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs (rank 0)."""
        return self.mesh.world_rank == 0

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, example_batch: Optional[PaddedGraph] = None) -> None:
        """Start a run at step 0: a fresh optimizer state over the model's
        parameters as they are (``create_model`` drew them from its seed, a
        converted bundle brings its own; over several ranks rank 0's are
        broadcast, then ``place_state`` lays them out) and ``seed`` for the
        steps' draws.

        ``example_batch`` is held to the band guard: a ``graph_window`` model
        on a batch with under 99% of its edges in-band raises ``ValueError``
        (or warns, with ``allow_out_of_band_graphs``)."""
        if example_batch is not None:
            self._check_band(example_batch)
        if getattr(self.model, "tp_layout", None) is None:
            replicate_tree(list(self.model.parameters()), self.mesh, "world")
        self.place_state()
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        layout = self.model.tp_layout
        self._sharded = [name in layout for name, p in self.model.named_parameters()
                         if p.requires_grad]
        self.optimizer = make_optimizer(self.config, self.params)
        # the reference's leaf order (flax sorts each level's names), for
        # the global norm of parameters below f32
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self._flax_order = sorted(range(len(names)), key=lambda i: names[i].split("."))
        self.seed, self.step, self.mini_step = int(seed), 0, 0
        self.accumulated = ([torch.zeros_like(p) for p in self.params]
                            if self.config.accumulate_grad_batches > 1 else [])
        n_params = sum(p.numel() for p in self.params)
        logger.info("training %.2fM parameters on %s", n_params / 1e6, self.device)

    def place_state(self) -> Dict[str, int]:
        """Lay the model's parameters out on the mesh (at init; a restored
        state is cut to the same layout by ``load_state_dict``): under a
        ``model`` axis above 1 this rank keeps its shards of the
        tensor-parallel kernels (``parallel.tp.place_state_tp``); otherwise
        every parameter stays whole. Returns ``{name: sharded dim}``."""
        layout = place_state_tp(self.model, self.mesh)
        if self._tp is not None:
            from ..convert import params_to_flax
            tree = nest(params_to_flax({k: v for k, v in self.model.named_parameters()},
                                       self.model))
            logger.info("tensor-parallel layout over %d ranks: %d parameters sharded (%s)",
                        self._tp.size, len(layout), describe_sharding(tree, self.mesh))
        return layout

    def _tp_state(self, state: Dict[str, Any], cut: bool) -> Dict[str, Any]:
        """A ``state_dict()``'s model, moments and accumulated gradients as
        whole tensors (gathered over the ``model`` line: a collective), or
        with ``cut`` a saved state's whole tensors cut to this rank's
        shards."""
        layout, tp = self.model.tp_layout, self._tp
        move = shard_state if cut else gather_state
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]

        def moments(i, s):
            dims = {k: layout[names[i]] for k in s if names[i] in layout and k != "step"}
            return move(s, dims, tp)

        opt = {**state["optimizer"], "state": {int(i): moments(int(i), s) for i, s in
                                               state["optimizer"]["state"].items()}}
        acc = state.get("accumulation", {"grads": [], "mini_step": 0})
        grads = [move({n: g}, layout, tp)[n] for n, g in zip(names, acc["grads"])]
        return {**state, "model": move(state["model"], layout, tp), "optimizer": opt,
                "accumulation": {**acc, "grads": grads}}

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
        ``step``, ``seed``, ``current_epoch`` and, with accumulation, the
        running-mean gradient and ``mini_step`` (tensors on the device).
        Under tensor parallelism the tensors are whole, gathered over the
        ``model`` line (every rank of it must call this)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": self.step, "seed": self.seed, "current_epoch": self.current_epoch,
                 "accumulation": {"grads": list(self.accumulated),
                                  "mini_step": self.mini_step}}
        return self._tp_state(state, cut=False) if self._tp is not None else state

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and buffers as whole tensors (a collective
        over the ``model`` line under tensor parallelism)."""
        state = self.model.state_dict()
        if self._tp is not None:
            state = gather_state(state, self.model.tp_layout, self._tp)
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Take up a ``state_dict()`` (from this device or another; whole
        tensors, which tensor parallelism cuts to this rank's shards); under
        data parallelism the first data rank's copy is then broadcast."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        if self._tp is not None:
            state = self._tp_state(state, cut=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.seed = int(state["step"]), int(state["seed"])
        self.current_epoch = int(state["current_epoch"])
        acc = state.get("accumulation", {"grads": [], "mini_step": 0})
        for mine, saved in zip(self.accumulated, acc["grads"]):
            mine.copy_(saved)
        self.mini_step = int(acc["mini_step"])
        if self._dp:
            moments = [t for s in self.optimizer.state.values() for t in s.values()
                       if torch.is_tensor(t) and t.device == self.device]
            replicate_tree(self.params + moments + self.accumulated, self._dp)

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------
    def _mean(self):
        return self._dp.mean if self._dp else local_mean

    def _line_mean(self):
        """The batch mean over a node block: counts over the model line, then
        over the data ranks."""
        return line_mean(self.mesh.axis(MODEL_AXIS), self._mean())

    def _replicas(self, plan: Optional[HaloPlan]) -> int:
        """The ranks that compute a graph-level loss alike: the data ranks
        (the global batch's loss, gathered) times, over node blocks, the
        model line."""
        return ((self._dp.size if self._dp else 1)
                * (self.mesh.axis(MODEL_AXIS).size if plan is not None else 1))

    def _pretrain_losses(self, batch: PaddedGraph, draws: Optional[Dict[str, torch.Tensor]],
                         plan: Optional[HaloPlan] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        draws = draws or {}
        cfg = self.config
        given = dict(mask_ratio=cfg.masking_ratio, deterministic=False,
                     generator=self.dropout_generator, masked=draws.get("masked"),
                     t=draws.get("t"), noise=draws.get("noise"))
        if plan is None:
            out = self.model.pretrain_step(batch, **given, batch_mean=self._mean(),
                                           moe_group_size=self._moe_group)
            emb, node_mask = out["node_embeddings"], batch.node_mask
        else:
            # per-node sums over the counts of the whole line and data batch
            out = sp_pretrain_step(self.model, batch, plan, self.mesh, **given,
                                   batch_mean=self._line_mean())
            # InfoNCE over the line's embeddings: every rank of the line alike
            emb = all_gather(out["node_embeddings"], self.mesh.axis(MODEL_AXIS), 1)
            node_mask = whole_node_mask(batch, self.mesh)
        metrics = {"diffusion_loss": out["diffusion_loss"],
                   "reconstruction_loss": out["reconstruction_loss"]}
        loss = out["diffusion_loss"] + cfg.reconstruction_weight * out["reconstruction_loss"]
        if cfg.use_contrastive_loss:
            closs = contrastive_loss(emb, node_mask, cfg.contrastive_temperature,
                                     uniform=draws.get("uniform"), generator=self.generator,
                                     gather=self._dp.gather if self._dp else None)
            # every rank of the data axis (and of a node block's line) holds
            # the whole loss: a share each
            closs = closs / self._replicas(plan)
            metrics["contrastive_loss"] = closs
            loss = loss + closs
        if "moe_aux_loss" in out:
            metrics["moe_aux_loss"] = out["moe_aux_loss"]
            loss = loss + cfg.moe_aux_weight * out["moe_aux_loss"]
        metrics["loss"] = loss
        return loss, metrics

    def _heads(self, out: Dict[str, Any], batch: PaddedGraph,
               node_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The head outputs, labels and graph validity that the finetune
        losses read, gathered over the ranks under data parallelism.
        ``node_mask``: the whole graphs' (default the batch's)."""
        node_mask = batch.node_mask if node_mask is None else node_mask
        heads = {"valid": node_mask.any(-1).float(), "y": batch.y}
        if self.task == "classification":
            heads["logits"] = out["classification_logits"].float()
        elif self.task == "regression":
            heads["pred"] = out["regression"]["mean"].float()
        elif self.task == "survival":
            heads.update({f"surv_{k}": v for k, v in out["survival"].items()})
        if self._dp:
            heads = {k: self._dp.gather(v) for k, v in heads.items()}
        return heads

    def _finetune_losses(self, batch: PaddedGraph, draws: Optional[Dict[str, torch.Tensor]],
                         plan: Optional[HaloPlan] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if batch.y is None:
            # unlabeled fallback: keep optimizing the self-supervised objective
            return self._pretrain_losses(batch, draws, plan)
        if plan is None:
            out = self.model(batch, mode="finetune", deterministic=False,
                             generator=self.dropout_generator, batch_mean=self._mean(),
                             moe_group_size=self._moe_group)
            h = self._heads(out, batch)
        else:
            out = sp_forward(self.model, batch, plan, self.mesh, mode="finetune",
                             deterministic=False, generator=self.dropout_generator)
            h = self._heads(out, batch, whole_node_mask(batch, self.mesh))
        valid, denom = h["valid"], h["valid"].sum().clamp_min(1.0)
        if self.task == "classification":
            labels = h["y"].long()
            per = F.cross_entropy(h["logits"], labels, reduction="none")
            loss = (per * valid).sum() / denom
            acc = ((h["logits"].argmax(-1) == labels).float() * valid).sum() / denom
            metrics = {"loss": loss, "accuracy": acc}
        elif self.task == "regression":
            pred = h["pred"]
            per = ((pred - h["y"].float().reshape(pred.shape)) ** 2).mean(-1)
            loss = (per * valid).sum() / denom
            metrics = {"loss": loss, "mse": loss}
        elif self.task == "survival":
            loss = self._survival_loss(h, valid)
            metrics = {"loss": loss, "survival_loss": loss}
        else:
            raise ValueError(f"finetune requires a task; got {self.task!r}")
        if self._replicas(plan) > 1:  # every rank holds the global loss: a share each
            metrics = {k: v / self._replicas(plan) for k, v in metrics.items()}
            loss = metrics["loss"]
        if "moe_aux_loss" in out:
            metrics["moe_aux_loss"] = out["moe_aux_loss"]
            loss = loss + self.config.moe_aux_weight * out["moe_aux_loss"]
            metrics["loss"] = loss
        return loss, metrics

    def _survival_loss(self, h: Dict[str, torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
        """h["y"] carries (time, event) pairs: [B, 2]."""
        time_, event = h["y"][..., 0].float(), h["y"][..., 1].float()
        if self.model.survival_mode == "cox":
            return cox_partial_likelihood(h["surv_risk"], time_, event, valid=valid)
        return discrete_survival_loss(h["surv_hazard_logits"], time_.long(), event,
                                      valid=valid)

    # ------------------------------------------------------------------
    # data parallelism
    # ------------------------------------------------------------------
    def _shard(self, batch: PaddedGraph, node: bool = False) -> PaddedGraph:
        """This rank's rows of a global batch, or with ``node`` of its
        node's training batch (filled up with filler graphs to a multiple
        of the ranks that split it); the batch itself without a mesh."""
        if not self._dp:
            return batch
        parts = self._dp.local if node else self._dp.size
        return shard_batch(pad_batch_to_devices(batch, parts), self._dp, node=node)

    @property
    def _nodes(self) -> int:
        return self._dp.nodes if self._dp else 1

    def _global_draws(self, batch: PaddedGraph, draws: Optional[Dict[str, torch.Tensor]],
                      contrastive: bool, nodes: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the pretrain draws, drawn at the global shape
        in the order the single-process path draws them (where the caller
        does not give them; given draws may lack the filler rows). ``nodes``:
        the whole graphs' node count where ``batch`` is a node block; the
        draws then keep every node, for the block's functions to cut."""
        dp, gen = self._dp, self.generator
        b, n = batch.node_mask.shape[0], nodes or batch.node_mask.shape[1]
        bg, dev = b * dp.size, batch.x.device
        given = {}
        for key, v in (draws or {}).items():
            v = v.to(dev)
            if v.shape[0] < bg:       # the filler graphs' rows
                v = torch.cat([v, v[-1:].repeat((bg - v.shape[0],) + (1,) * (v.dim() - 1))])
            given[key] = v
        if "masked" not in given:
            given["masked"] = torch.rand((bg, n), generator=gen, device=dev) \
                < self.config.masking_ratio
        if "t" not in given:
            given["t"] = torch.randint(0, self.model.num_diffusion_steps, (bg,),
                                       generator=gen, device=dev)
        if "noise" not in given:             # drawn in f32, then cast, as randn_like
            given["noise"] = torch.randn((bg, n, self.model.hidden_dims[-1]), generator=gen,
                                         device=dev, dtype=torch.float32).to(self.model.dtype)
        if contrastive and "uniform" not in given and n > CONTRASTIVE_NODES:
            given["uniform"] = torch.rand((bg, n), generator=gen, device=dev)
        local = {k: shard_rows(v, dp) for k, v in given.items()}
        if nodes is None:
            local["masked"] = local["masked"] & batch.node_mask
        return local

    def _set_moe_group(self, batch: PaddedGraph) -> None:
        """Under data parallelism the MoE routes in the groups of the global
        batch: a group may not straddle two ranks."""
        self._moe_group = None
        if not (self._dp and self.model.moe_experts):
            return
        b, n = batch.node_mask.shape
        grp = routing_group(b * self._dp.size * n, n, self.model.moe_ffn.group_size)
        if (b * n) % grp:
            raise ValueError(f"an MoE routing group of {grp} tokens would straddle two "
                             f"ranks ({b} graphs of {n} nodes a rank)")
        self._moe_group = grp

    def _grad_norm(self, grads: list) -> torch.Tensor:
        """The global norm of the whole gradient (under tensor parallelism
        from this rank's shards and the replicated leaves)."""
        if self._tp is not None:
            return grad_norm(grads, self._sharded, self._tp)
        if isinstance(self.optimizer, OptaxAdamW):
            return optax_global_norm([grads[i] for i in self._flax_order])
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    def _update(self, grads: list, norm: Optional[torch.Tensor] = None) -> None:
        """Clip + AdamW, or with ``accumulate_grad_batches = k > 1`` fold
        ``grads`` into the running mean and apply it every k-th call.
        ``norm``: the global norm of ``grads`` where the caller has it."""
        k = self.config.accumulate_grad_batches
        if k == 1:
            clip_and_step(self.params, self.optimizer, self.lr_schedule(self.step),
                          self.config.gradient_clip_val,
                          self._grad_norm(grads) if norm is None else norm)
            return
        acc, n = self.accumulated, self.mini_step
        torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc), n + 1))
        if n == k - 1:
            for p, a in zip(self.params, acc):
                p.grad = a.clone()
            # the rate follows the applied updates: this is update step // k
            clip_and_step(self.params, self.optimizer, self.lr_schedule(self.step // k),
                          self.config.gradient_clip_val, self._grad_norm(acc))
            torch._foreach_zero_(acc)
        self.mini_step = (n + 1) % k

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def phase_for_epoch(self, epoch: int) -> str:
        return "pretrain" if epoch < self.config.pretrain_epochs else "finetune"

    def training_step(self, batch: PaddedGraph, epoch: Optional[int] = None,
                      materialize: bool = True,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      prepared: bool = False, plan: Optional[HaloPlan] = None
                      ) -> Dict[str, Any]:
        """One optimization step (one mini-step with accumulation); returns
        the phase's scalar metrics and ``grad_norm`` (the global norm of the
        step's own gradient, before clipping).

        ``batch`` is this node's batch, the global batch when there is one
        node: under data parallelism each rank takes its rows.
        ``materialize=False`` returns 0-d tensors on the device without a
        host sync. ``draws`` may hold the pretrain draws of the global
        batch, ``masked`` [B, N] bool, ``t`` [B], ``noise`` [B, N, hidden]
        and ``uniform`` [B, N] (the contrastive subsample scores), in place
        of the generator's.

        ``prepared=True``: ``batch`` is this rank's part already. With
        ``plan`` (``parallel.halo.build_halo_plan`` of the whole batch) it is
        this rank's node block, ``parallel.shard_graph_nodes(batch, mesh)``
        over a ``(data, model)`` mesh: the step over node-sharded inputs
        (``parallel/sp.py``), the counterpart of JAX
        ``training_step(shard_graph_nodes(batch, mesh), prepared=True)``. It
        equals one process's step on the whole batch (under data parallelism,
        the data-parallel step's): the draws are the whole graphs' cut to the
        block (the dropout masks too, each row taking its node's, at the
        pooled levels as well: ``nn.layers.NodeRows``), per-node losses are this rank's
        sums over the whole counts, a graph-level loss is shared by the
        ranks of the line, and the gradients are summed over the line
        (under tensor parallelism the sharded kernels computed whole, their
        gradients cut back to the shards before the clip).
        """
        if plan is not None:
            if not prepared:
                raise ValueError("a halo plan goes with a node block: pass prepared=True and "
                                 "parallel.shard_graph_nodes(batch, mesh)")
            return self._step(batch.to(self.device), epoch, materialize, draws, plan)
        if prepared:
            return self._step(batch.to(self.device), epoch, materialize, draws)
        batch = self._shard(batch, node=True).to(self.device)
        if self._nodes > 1:
            batch = align_node_batches(batch, None, self._dp)
        return self._step(batch, epoch, materialize, draws)

    def _sum_line(self, grads: list, values: torch.Tensor) -> torch.Tensor:
        """Over node blocks: the replicated parameters' gradients (in place)
        and the metrics' shares summed over the model line in one all-reduce
        (the sharded kernels' gradients are summed by their gather's
        backward); returns the summed ``values``."""
        line = self.mesh.axis(MODEL_AXIS)
        rep = [g for g, s in zip(grads, self._sharded) if not s]
        flat = line.all_reduce_(torch.cat([g.reshape(-1) for g in rep] + [values]))
        offset = 0
        for g in rep:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:]

    def _step(self, batch: PaddedGraph, epoch: Optional[int], materialize: bool,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              plan: Optional[HaloPlan] = None) -> Dict[str, Any]:
        """``training_step`` on this rank's rows (or node block, with
        ``plan``), on the device."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        epoch = self.current_epoch if epoch is None else epoch
        pretrain = self.phase_for_epoch(epoch) == "pretrain"
        loss_fn = self._pretrain_losses if pretrain else self._finetune_losses
        self.generator.manual_seed(_fold(self.seed, self.step))
        nodes = None if plan is None else plan.n_local * plan.tp
        if self._dp:
            self.dropout_generator.manual_seed(
                _fold(_fold(self.seed, self.step), 1 + self._dp.rank))
            self._set_moe_group(batch)
            if pretrain or batch.y is None:
                draws = self._global_draws(batch, draws, self.config.use_contrastive_loss,
                                           nodes)
        elif draws is not None:
            draws = {k: v.to(self.device) for k, v in draws.items()}

        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, draws, plan)
        loss.float().backward()
        for p in self.params:               # unreached parameters still decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        names = sorted(metrics)             # in key order, as the reference returns them
        values = torch.stack([metrics[k].detach().float() for k in names])
        if plan is not None:
            values = self._sum_line(grads, values)
        elif self._tp is not None:
            # the replicas of a model line stay equal to the bit
            unify_replicated(grads, self._sharded, self._tp)
        if self._dp:
            # one all-reduce sums the gradients and the metrics' shares
            values = self._dp.sum_grads(grads, values)
        norm = self._grad_norm(grads)
        self._update(grads, norm)
        self.step += 1

        metrics = dict(zip(names, values.unbind()))
        metrics["grad_norm"] = norm.float()
        metrics = {k: metrics[k] for k in sorted(metrics)}
        if materialize:
            return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
        return metrics

    @torch.no_grad()
    def validation_step(self, batch: PaddedGraph, epoch: Optional[int] = None,
                        draws: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """Deterministic evaluation of one (global) batch (tensors on the
        device). Pretrain phase or no labels: ``loss`` = diffusion +
        reconstruction, its draws taken from the validation stream of the
        seed. Under data parallelism each rank scores its rows and every
        rank returns the global batch's values."""
        epoch = self.current_epoch if epoch is None else epoch
        batch = self._shard(batch).to(self.device)
        self._set_moe_group(batch)
        moe = {"batch_mean": self._mean(), "moe_group_size": self._moe_group}
        if self.phase_for_epoch(epoch) == "pretrain" or batch.y is None:
            self.generator.manual_seed(_fold(self.seed, VALIDATION_STREAM))
            if self._dp:
                draws = self._global_draws(batch, draws, contrastive=False)
            draws = draws or {}
            out = self.model.pretrain_step(
                batch, mask_ratio=self.config.masking_ratio, deterministic=True,
                generator=self.generator, masked=draws.get("masked"), t=draws.get("t"),
                noise=draws.get("noise"), **moe)
            loss = out["diffusion_loss"] + out["reconstruction_loss"]
            return {"loss": self._dp.all_reduce(loss) if self._dp else loss}
        out = self.model(batch, mode="inference", deterministic=True, **moe)
        h = self._heads(out, batch)
        valid, denom = h["valid"], h["valid"].sum().clamp_min(1.0)
        if self.task == "classification":
            logits, labels = h["logits"], h["y"].long()
            per = F.cross_entropy(logits, labels, reduction="none")
            correct = (logits.argmax(-1) == labels).float()
            return {"loss": (per * valid).sum() / denom,
                    "accuracy": (correct * valid).sum() / denom, "valid": valid,
                    "probabilities": torch.softmax(logits, -1)}
        if self.task == "survival":
            loss = self._survival_loss(h, valid)
            risk = (h["surv_risk"].float() if self.model.survival_mode == "cox"
                    else -h["surv_survival"].sum(-1))   # -E[survival time] proxy
            return {"loss": loss, "valid": valid, "risk": risk,
                    "time": h["y"][..., 0].float(), "event": h["y"][..., 1].float()}
        pred = h["pred"]
        per = ((pred - h["y"].float().reshape(pred.shape)) ** 2).mean(-1)
        return {"loss": (per * valid).sum() / denom, "valid": valid}

    def _epoch_steps(self, prepared: Iterable, loader: Iterable) -> Iterator[PaddedGraph]:
        """This rank's rows of each step of an epoch, on the device. Over
        several nodes they take the shape all ranks agree on, and once this
        node's loader has run out while another's has not, filler graphs
        shaped like its last batch (or its loader's first, when a resumed
        epoch skipped every batch it had)."""
        like = None
        for batch in prepared:
            if self._nodes > 1:
                batch = like = align_node_batches(batch, None, self._dp)
            yield batch
        while self._nodes > 1:
            if like is None:
                first = next(iter(loader), None)
                like = first if first is None else self._shard(first, node=True).to(self.device)
            like = align_node_batches(None, like, self._dp)
            if like is None:
                return
            yield like

    def _agree(self, flag: bool) -> bool:
        """``flag`` on any rank (a host-side collective over several ranks)."""
        return self.mesh.any(flag) if self.mesh.world is not None else flag

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
        Over several ranks only rank 0 saves and logs (under tensor
        parallelism every rank gathers the state it saves); every rank takes
        the same steps, scores the same global validation batches and stops
        at the same step boundary on a preemption (the ranks agree on it).
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
        # under tensor parallelism every rank gathers the state the writer saves
        gathering = self._tp is not None and self._agree(
            checkpoint_manager is not None and self.is_writer)
        if not self.is_writer:
            checkpoint_manager = train_logger = None

        def save(**kwargs) -> None:
            if checkpoint_manager is not None or gathering:
                state = self.state_dict()
                if checkpoint_manager is not None:
                    checkpoint_manager.save(state, step=self.current_epoch, **kwargs)
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
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            epoch_loader = skip_batches(train_loader, skip) if skip else train_loader
            with monitor_operation(f"train_epoch_{phase}"):
                # this rank's rows, sharded and uploaded on the prefetch thread
                prepared = device_put_prefetch(
                    (self._shard(b, node=True) for b in epoch_loader), self.device, depth=2)
                for batch in self._epoch_steps(prepared, train_loader):
                    # accumulated on the device: one host sync per epoch
                    m = self._step(batch, epoch, materialize=False)
                    n_steps += 1
                    for k, v in m.items():
                        totals[k] = v if k not in totals else totals[k] + v
                    if n_steps % log_every == 0:
                        logger.info("epoch %d [%s] step %d loss=%.4f", epoch, phase,
                                    n_steps, float(m["loss"]))
                    if preemption_guard is not None and self._agree(preemption_guard.triggered):
                        interrupted = True
                        prepared.close()
                        break
            if interrupted:
                resume_info = {"epoch": epoch, "step_in_epoch": n_steps, "mid_epoch": True}
                logger.warning("preemption: stopping at epoch %d step %d", epoch, n_steps)
                save(extra={"resume": resume_info})
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
                save(metric=summary["val_loss"])
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
    def from_config(cls, cfg: DGDMConfig, mesh: Optional[Mesh] = None,
                    device=None) -> "DGDMTrainer":
        """A trainer over a ``DGDMModel`` built from ``cfg.model`` (the
        classification / regression / survival sections switch their heads
        on), its parameters drawn from ``cfg.experiment.seed``. Without
        ``mesh``, ``hardware.mesh_shape`` / ``mesh_axes`` give one (with a
        ``model`` axis the tensor-parallel layout); ``hardware.devices`` is
        not read, as in the reference."""
        hw = cfg.hardware
        if mesh is None and hw.mesh_shape:
            mesh = make_mesh(shape=list(hw.mesh_shape), axes=tuple(hw.mesh_axes))
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
        return cls(model, TrainerConfig.from_config(cfg), device=device, mesh=mesh)
