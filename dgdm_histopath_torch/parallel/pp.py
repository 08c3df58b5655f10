"""GPipe pipeline parallelism for the GraphEncoder's layer stack over a
``pipe`` mesh axis (counterpart of the JAX package's ``parallel/pp.py``).

The ``L`` shape-homogeneous ``DynamicGraphLayer``s are stacked leaf-wise
into one tree with a leading ``[L]`` axis (``stack_layer_params``); stage
``s`` of ``S`` runs layers ``[s·L/S, (s+1)·L/S)`` through
``torch.func.functional_call`` on its slice. The batch is cut into ``M``
microbatches and the schedule runs ``M + S - 1`` ticks: at tick ``t`` stage
``s`` applies its layers (each followed by the activation) to microbatch
``m = t - s`` when ``0 <= m < M``, then every stage shifts its output one
stage forward over its ``pipe`` line (``Axis.shift``, the JAX ``ppermute``;
a stage with nothing at a tick sends zeros). The last stage's outputs are
broadcast back to every stage, as JAX's masked ``psum`` does, so the model
tail can run on every rank. The bubble is ``(S-1)/(M+S-1)``.

The forward keeps only each tick's stage input; the backward is GPipe's:
one ``torch.autograd.Function`` runs the ticks in reverse, recomputes each
stage from its saved input, and shifts the input gradients one stage back,
the way the forward came. The gradients of the stacked parameters are this
stage's; those of the layer stack's input and of the projected edge
features, which every stage reads, are summed over the line, so the
projections that feed them (replicated over ``pipe``) get the same whole
gradient on every rank. Running the collectives from one Function keeps
their order the same on every rank.

With a ``data`` axis the caller passes its data index's rows (and gets
them back); ``pp_graph_encoder_apply`` cuts them itself. Deterministic mode
only, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..ops.kernels.neighbor_transpose import transpose_for_backward
from .mesh import Axis, Mesh

PIPE_AXIS = "pipe"


def pipe_size(mesh: Mesh) -> int:
    """Size of the ``pipe`` axis (1 when the mesh has none)."""
    return mesh.shape[mesh.axes.index(PIPE_AXIS)] if PIPE_AXIS in mesh.axes else 1


def stack_layer_params(encoder_params, num_layers: int) -> Dict[str, torch.Tensor]:
    """Stack ``layer0 .. layer{L-1}``'s parameters into one ``{name: [L, ...]}``
    tree. ``encoder_params`` is a ``GraphEncoder`` or a mapping of its
    parameters (``named_parameters`` / ``state_dict`` keys). The layers are
    shape-homogeneous (``input_proj`` lifts x to ``hidden_dim`` before layer
    0), which makes the stacking axis well-defined; stacking keeps the
    gradient path to the layers' own parameters."""
    if isinstance(encoder_params, nn.Module):
        encoder_params = dict(encoder_params.named_parameters())
    layers = []
    for i in range(num_layers):
        prefix = f"layer{i}."
        sub = {k[len(prefix):]: v for k, v in encoder_params.items() if k.startswith(prefix)}
        if not sub:
            have = sorted({k.split(".")[0] for k in encoder_params})
            raise ValueError(f"encoder params missing 'layer{i}' (has {have})")
        layers.append(sub)
    return {name: torch.stack([sub[name] for sub in layers]) for name in layers[0]}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor], num_layers: int
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params`: ``{"layer{i}.name": tensor}``."""
    return {f"layer{i}.{name}": t[i] for i in range(num_layers) for name, t in stacked.items()}


def pp_bubble_fraction(n_stages: int, num_micro: int) -> float:
    """Idle fraction of the GPipe schedule: ``(S-1)/(M+S-1)``."""
    return (n_stages - 1) / (num_micro + n_stages - 1)


class _Schedule:
    """One call's GPipe schedule on this stage (its microbatches' indices,
    masks and transposed lists, the layer template and the activation)."""

    def __init__(self, axis: Axis, layer: nn.Module, activation: Callable, names: Sequence[str],
                 per_stage: int, num_micro: int, nbr_idx, nbr_mask):
        self.axis, self.layer, self.act = axis, layer, activation
        self.names, self.per_stage, self.m = list(names), per_stage, num_micro
        self.idx = nbr_idx.chunk(num_micro)
        self.mask = nbr_mask.chunk(num_micro)
        self.nbr_t = [None] * num_micro

    @property
    def ticks(self) -> int:
        return self.m + self.axis.size - 1

    def stage(self, x, m: int, e, params: Sequence[torch.Tensor]):
        """This stage's layers on microbatch ``m``."""
        for i in range(self.per_stage):
            p = {n: params[j][i] for j, n in enumerate(self.names)}
            x = self.act(functional_call(self.layer, p, (x, self.idx[m], self.mask[m], e),
                                         {"deterministic": True, "nbr_t": self.nbr_t[m]}))
        return x

    def forward(self, h, e, params):
        """Outputs of every microbatch (broadcast from the last stage) and
        this stage's input at each tick it worked."""
        s, last = self.axis.index, self.axis.size - 1
        h_m, e_m = h.chunk(self.m), (None if e is None else e.chunk(self.m))
        state = torch.zeros_like(h_m[0])
        inputs, outs = {}, [torch.zeros_like(h_m[0]) for _ in range(self.m)]
        for t in range(self.ticks):
            m = t - s
            if 0 <= m < self.m:
                x = h_m[m] if s == 0 else state
                inputs[t] = x
                y = self.stage(x, m, None if e is None else e_m[m], params)
                if s == last:
                    outs[m] = y
            else:
                y = torch.zeros_like(state)
            if t < self.ticks - 1:
                state = self.axis.shift(y, 1)
        return self.axis.broadcast_(torch.cat(outs).contiguous(), last), inputs

    def backward(self, g_out, inputs, e, params):
        """(dh, de, d params) by the reverse schedule."""
        s, last = self.axis.index, self.axis.size - 1
        g_m = g_out.contiguous().chunk(self.m)
        e_m = None if e is None else e.chunk(self.m)
        dh = [torch.zeros_like(g) for g in g_m]
        de = None if e is None else [torch.zeros_like(x) for x in e_m]
        dp = [None] * len(params)          # None stays for a parameter no layer read
        g_recv = None
        for t in reversed(range(self.ticks)):
            m = t - s
            if 0 <= m < self.m:
                gy = g_m[m] if s == last else g_recv
                with torch.enable_grad():
                    x = inputs[t].detach().requires_grad_()
                    ev = None if e is None else e_m[m].detach().requires_grad_()
                    ps = [p.detach().requires_grad_() for p in params]
                    if self.nbr_t[m] is None:
                        self.nbr_t[m] = transpose_for_backward(self.idx[m])
                    y = self.stage(x, m, ev, ps)
                    wrt = [x] + ([ev] if ev is not None else []) + ps
                    grads = torch.autograd.grad(y, wrt, gy, allow_unused=True)
                gx, rest = grads[0], list(grads[1:])
                if ev is not None:
                    ge = rest.pop(0)
                    if ge is not None:
                        de[m] += ge
                for j, g in enumerate(rest):
                    if g is not None:
                        dp[j] = g if dp[j] is None else dp[j] + g
                if s == 0:
                    dh[m] = gx
            else:
                gx = torch.zeros_like(g_m[0])
            if t > 0:
                g_recv = self.axis.shift(gx, -1)
        dh = self.axis.all_reduce_(torch.cat(dh))      # stage 0's: zeros elsewhere
        if de is not None:
            de = self.axis.all_reduce_(torch.cat(de))  # every stage read e
        return dh, de, dp


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, h, e, *params):
        out, inputs = schedule.forward(h, e, params)
        ctx.schedule, ctx.inputs = schedule, inputs
        ctx.save_for_backward(*([e] if e is not None else []), *params)
        ctx.has_e = e is not None
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        saved = list(ctx.saved_tensors)
        e = saved.pop(0) if ctx.has_e else None
        dh, de, dp = ctx.schedule.backward(g_out, ctx.inputs, e, saved)
        return (None, dh, de, *dp)


def make_pp_layers_fn(mesh: Mesh, layer_module: nn.Module, activation: Callable,
                      num_layers: int, num_micro: int, *, has_edges: bool = True
                      ) -> Callable:
    """The pipelined equivalent of the GraphEncoder's layer loop:
    ``fn(stacked, h, nbr_idx, nbr_mask[, e]) -> h_out`` equals ``for i in
    range(L): h = act(layer_i(h, ...))`` (deterministic mode). ``stacked``
    is the whole ``[L, ...]`` tree of :func:`stack_layer_params`; this
    stage runs its slice. ``layer_module`` is a ``DynamicGraphLayer`` of the
    layers' configuration (its own parameters are not read). ``h`` and the
    rest are this rank's rows."""
    axis = mesh.axis(PIPE_AXIS) if PIPE_AXIS in mesh.axes else Axis(PIPE_AXIS)
    n_stages = axis.size
    if n_stages < 1 or num_layers % n_stages != 0:
        raise ValueError(f"num_layers ({num_layers}) must be divisible by the pipe axis "
                         f"({n_stages})")
    if num_micro < 1:
        raise ValueError("num_micro must be >= 1")
    per_stage = num_layers // n_stages

    def fn(stacked: Mapping[str, torch.Tensor], h, nbr_idx, nbr_mask, e=None):
        if has_edges != (e is not None):
            raise ValueError("edge features given to a pipeline built without them, or "
                             "missing from one built with them")
        if h.shape[0] % num_micro != 0:
            raise ValueError(f"per-shard batch {h.shape[0]} not divisible by num_micro "
                             f"{num_micro}")
        names = list(stacked)
        lo = axis.index * per_stage
        params = [stacked[n][lo:lo + per_stage] for n in names]
        schedule = _Schedule(axis, layer_module, activation, names, per_stage, num_micro,
                             nbr_idx, nbr_mask)
        return _Pipeline.apply(schedule, h, e, *params)

    return fn


def pp_graph_encoder_apply(encoder: nn.Module, mesh: Mesh, x: torch.Tensor,
                           nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                           node_mask: torch.Tensor, edge_attr: Optional[torch.Tensor] = None,
                           *, num_micro: Optional[int] = None, data_axis: Optional[str] = None
                           ) -> torch.Tensor:
    """A ``GraphEncoder``'s forward (its ``embeddings``) with the layer stack
    pipelined over ``pipe``; deterministic mode. The input, edge and output
    projections run on every stage. With ``data_axis`` the batch is cut to
    this rank's data index's rows, which is what it returns."""
    from ..nn.graph_layers import DynamicGraphLayer

    if data_axis is not None:
        line = mesh.axis(data_axis)
        n = x.shape[0] // line.size
        cut = slice(line.index * n, (line.index + 1) * n)
        x, nbr_idx, nbr_mask, node_mask = x[cut], nbr_idx[cut], nbr_mask[cut], node_mask[cut]
        edge_attr = None if edge_attr is None else edge_attr[cut]
    h = encoder.input_proj(x)
    e = None
    if edge_attr is not None and encoder.edge_proj is not None:
        e = encoder.edge_proj(edge_attr.to(h.dtype))
    masked_nbr = nbr_mask & node_mask[..., None]
    stacked = stack_layer_params(encoder, encoder.num_layers)
    layer0 = encoder.layer0
    edge_dim = None if layer0.edge_k_proj is None else layer0.edge_k_proj.in_features
    template = DynamicGraphLayer(layer0.features, layer0.features, layer0.num_heads, edge_dim,
                                 0.0, layer0.compute_dtype, layer0.band_window).to(x.device)
    if num_micro is None:
        num_micro = max(1, min(2 * pipe_size(mesh), int(x.shape[0])))
    fn = make_pp_layers_fn(mesh, template, encoder.act, encoder.num_layers, num_micro,
                           has_edges=e is not None)
    h = fn(stacked, h, nbr_idx, masked_nbr, e)
    out = encoder.output_proj(h)
    return out * node_mask[..., None].to(out.dtype)


__all__ = ["PIPE_AXIS", "make_pp_layers_fn", "pipe_size", "pp_bubble_fraction",
           "pp_graph_encoder_apply", "stack_layer_params", "unstack_layer_params"]
