"""Tensor parallelism over the ``model`` axis of a ``(data, model)`` mesh
(counterpart of the JAX package's ``parallel/tp.py``).

The layout rule is the JAX package's, applied to the JAX parameter tree
(``convert.params_to_flax`` names each port parameter by its flax path), so
that the two layouts agree leaf for leaf:

* a **2-D** kernel ``[in, out]`` is column-parallel (sharded on ``out``)
  when ``out`` divides by the ``model`` size, else row-parallel (sharded on
  ``in``) when ``in`` does, else replicated;
* a ``bias`` is sharded only beside a column-parallel ``kernel`` in the
  same module dict;
* everything else replicates. That includes every flax ``nn.DenseGeneral``
  site (3-D kernels ``[in, heads, head_dim]`` or ``[heads, head_dim, out]``;
  the port's ``DenseGeneral`` stores them 2-D), ``GraphConvolution``'s own
  bias (beside the ``lin`` subtree, not inside it), LayerNorms and the MoE's
  ``[E, ...]`` expert leaves.

JAX gets the computation from GSPMD; here each sharded ``Dense`` computes
with explicit collectives over its ``model`` line (``place_state_tp`` makes
it a ``TPDense``):

* column-parallel: ``y_r = x W_r + b_r``, then ``y`` all-gathered along its
  last dim; in the backward the incoming gradient is cut to this rank's
  columns and ``dx`` (partial over the columns) is all-reduced;
* row-parallel: ``y = Σ_r x_r W_r`` over this rank's slice ``x_r`` of the
  input, all-reduced in f32, plus the bias once; in the backward ``dx_r`` is
  all-gathered.

Every rank of a ``model`` line holds the same activations and the same loss
(the rows of its data index), so those four collectives are the
replicated-loss conjugate pairs of ``mesh.py``, not its summed adjoints.
Each rank keeps only its shards of the parameters, and AdamW, built over
them, only its shards of the moments. The gradients of replicated
parameters are equal on every rank of the line; the trainer broadcasts
them from the line's first rank so that the replicas cannot drift, and the
global-norm clip sums the sharded leaves' squares over the line and counts
each replicated leaf once (``grad_norm``). Checkpoints hold whole tensors
(``gather_state``), and ``shard_state`` cuts a restored one again.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense
from .mesh import (MODEL_AXIS, Axis, Mesh, copy_to_line, gather_from_line, reduce_from_line,
                   scatter_to_line)

COLUMN = (None, MODEL_AXIS)     # a [in, out] kernel sharded on out
ROW = (MODEL_AXIS, None)        # ... on in
SHARDED_BIAS = (MODEL_AXIS,)
REPLICATED = ()


def tp_size(mesh: Mesh) -> int:
    """Size of the ``model`` axis (1 when the mesh has none)."""
    return mesh.shape[mesh.axes.index(MODEL_AXIS)] if MODEL_AXIS in mesh.axes else 1


def _kernel_spec(shape: Sequence[int], tp: int) -> tuple:
    if len(shape) == 2:
        if shape[1] % tp == 0 and shape[1] >= tp:
            return COLUMN
        if shape[0] % tp == 0 and shape[0] >= tp:
            return ROW
    return REPLICATED


def _walk(node: Mapping, tp: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    kspec = (_kernel_spec(tuple(node["kernel"].shape), tp)
             if hasattr(node.get("kernel"), "shape") else None)
    for name, child in node.items():
        if isinstance(child, Mapping):
            out[name] = _walk(child, tp)
        elif name == "kernel":
            out[name] = kspec
        elif name == "bias" and kspec == COLUMN:
            out[name] = SHARDED_BIAS            # follows the column-parallel kernel
        else:
            out[name] = REPLICATED              # scales, tokens, row-parallel bias
    return out


def _replicated_like(node: Any) -> Any:
    if isinstance(node, Mapping):
        return {k: _replicated_like(v) for k, v in node.items()}
    return REPLICATED


def tp_param_specs(params: Mapping, mesh: Mesh) -> Dict[str, Any]:
    """The spec tree of a JAX-layout parameter tree (nested mappings of
    arrays or tensors with a ``shape``, e.g. ``nest(params_to_flax(...))``):
    each leaf's spec is a tuple naming, per dim, ``"model"`` or None, as a
    ``PartitionSpec`` does (``()`` replicated). All replicated when the mesh
    has no ``model`` axis above 1."""
    tp = tp_size(mesh)
    return _walk(params, tp) if tp > 1 else _replicated_like(params)


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"params/a/kernel": x}`` -> ``{"params": {"a": {"kernel": x}}}``."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flatten_specs(tree: Mapping, prefix: str = "") -> Dict[str, tuple]:
    """A nested spec tree -> ``{"params/a/kernel": spec}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_specs(value, path + "/"))
        else:
            flat[path] = value
    return flat


def shard_tree_like(tree: Mapping, specs: Mapping, mesh: Mesh) -> Dict[str, Any]:
    """This rank's part of every leaf (a tensor or an array) of ``tree`` under
    its spec (a dim that names a mesh axis is cut into that axis's size and
    this rank keeps the block of its index). ``specs`` may be the spec tree of a sub-structure
    applied to a congruent tree: a leaf without its own path takes the spec
    of the longest path that ends its own (the JAX rule for optimizer
    moments under extra prefixes), else replicates."""
    flat = flatten_specs(specs)

    def spec_of(path: str) -> tuple:
        if path in flat:
            return flat[path]
        parts = path.split("/")
        for i in range(1, len(parts)):
            suffix = "/".join(parts[i:])
            hit = [s for p, s in flat.items() if p == suffix or p.endswith("/" + suffix)]
            if hit:
                return hit[0]
        return REPLICATED

    def place(node: Mapping, prefix: str) -> Dict[str, Any]:
        out = {}
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, Mapping):
                out[key] = place(value, path + "/")
                continue
            spec, part = spec_of(path), value
            for dim, name in enumerate(spec):
                if name is not None:
                    line = mesh.axis(name)
                    n = part.shape[dim] // line.size
                    cut = slice(line.index * n, (line.index + 1) * n)
                    part = part[(slice(None),) * dim + (cut,)]     # tensors and arrays
            out[key] = part
        return out

    return place(tree, "")


def describe_sharding(params: Mapping, mesh: Mesh) -> Dict[str, int]:
    """How many leaves got which layout (a sharded bias counts with its
    column-parallel kernel)."""
    counts = {"column": 0, "row": 0, "replicated": 0}
    for spec in flatten_specs(tp_param_specs(params, mesh)).values():
        if spec in (COLUMN, SHARDED_BIAS):
            counts["column"] += 1
        elif spec == ROW:
            counts["row"] += 1
        else:
            counts["replicated"] += 1
    return counts


def model_layout(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """``{port parameter name: the dim of its port tensor that is sharded}``
    by the rule above on ``model``'s JAX parameter tree: a column-parallel
    kernel ``[in, out]`` is the port weight ``[out, in]`` cut on dim 0, a
    row-parallel one on dim 1, a sharded bias on dim 0."""
    from ..convert import params_to_flax

    state = {k: p.detach() for k, p in model.named_parameters()}
    flat = params_to_flax(state, model)        # one flax path a key, in order
    specs = flatten_specs(tp_param_specs(nest(flat), mesh))
    port_dim = {COLUMN: 0, ROW: 1, SHARDED_BIAS: 0}
    return {key: port_dim[specs[path]] for key, path in zip(state, flat)
            if specs[path] in port_dim}


class TPDense(Dense):
    """A ``Dense`` whose parameters are this rank's shards: ``kind``
    "column" or "row" over ``axis`` (``place_state_tp`` turns a ``Dense``
    into one in place)."""

    kind: str
    axis: Axis

    @classmethod
    def adopt(cls, dense: Dense, kind: str, axis: Axis) -> "TPDense":
        if kind not in ("column", "row"):
            raise ValueError(f"unknown tensor-parallel kind {kind!r}")
        dense.__class__ = cls
        dense.kind, dense.axis = kind, axis
        return dense

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.kind == "column":
            y = F.linear(copy_to_line(x.to(dt), self.axis), self.weight.to(dt), bias)
            return gather_from_line(y, self.axis, -1)
        part = F.linear(scatter_to_line(x.to(dt), self.axis, -1), self.weight.to(dt))
        y = reduce_from_line(part.float(), self.axis)
        if bias is not None:
            y = y + bias.float()
        return y.to(dt)


def place_state_tp(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Cut ``model``'s tensor-parallel parameters to this rank's shards, in
    place, and make each sharded ``Dense`` a ``TPDense`` (an
    optimizer built afterwards keeps its moments in the same shards).
    Returns the layout (``model_layout``); a model placed already keeps its
    layout. Nothing changes on a mesh without a ``model`` axis above 1."""
    if getattr(model, "tp_layout", None) is not None:
        return model.tp_layout
    layout = model_layout(model, mesh) if tp_size(mesh) > 1 else {}
    axis = mesh.axis(MODEL_AXIS) if layout else None
    modules = dict(model.named_modules())
    for key, dim in layout.items():
        owner, _, leaf = key.rpartition(".")
        module = modules[owner]
        if not isinstance(module, Dense):
            raise TypeError(f"{key}: only Dense layers are tensor-parallel here")
        full = getattr(module, leaf)
        n = full.shape[dim] // axis.size
        setattr(module, leaf, nn.Parameter(full.detach().narrow(dim, axis.index * n, n)
                                           .clone(), requires_grad=full.requires_grad))
        if leaf == "weight":
            TPDense.adopt(module, "column" if dim == 0 else "row", axis)
    model.tp_layout = layout
    return layout


def gather_state(state: Mapping[str, torch.Tensor], layout: Mapping[str, int],
                 axis: Axis) -> Dict[str, torch.Tensor]:
    """Whole tensors from this rank's shards (a collective over the line):
    each key of ``layout`` all-gathered along its dim, the rest as it is."""
    return {k: (axis.all_gather(v.contiguous(), layout[k]) if k in layout else v)
            for k, v in state.items()}


def shard_state(state: Mapping[str, torch.Tensor], layout: Mapping[str, int],
                axis: Axis) -> Dict[str, torch.Tensor]:
    """This rank's blocks of whole tensors (no collective)."""
    out = {}
    for k, v in state.items():
        if k in layout and torch.is_tensor(v):
            n = v.shape[layout[k]] // axis.size
            v = v.narrow(layout[k], axis.index * n, n).clone()
        out[k] = v
    return out


def grad_norm(grads: Sequence[torch.Tensor], sharded: Sequence[bool], axis: Axis
              ) -> torch.Tensor:
    """The global norm of the whole gradient from this rank's part: the
    sharded leaves' squares summed over the line, each replicated leaf
    counted once."""
    def sq(gs):
        if not gs:
            return torch.zeros((), device=grads[0].device)
        return torch.stack(torch._foreach_norm(gs)).square().sum()

    part = sq([g for g, s in zip(grads, sharded) if s])
    rep = sq([g for g, s in zip(grads, sharded) if not s])
    return (axis.all_reduce_(part.float().clone()) + rep.float()).sqrt()


def unify_replicated(grads: Sequence[torch.Tensor], sharded: Sequence[bool],
                     axis: Axis) -> None:
    """Broadcast the replicated leaves' gradients from the line's first rank
    (one flat broadcast), in place."""
    rep = [g for g, s in zip(grads, sharded) if not s]
    if axis.size == 1 or not rep:
        return
    flat = axis.broadcast_(torch.cat([g.reshape(-1) for g in rep]), 0)
    offset = 0
    for g in rep:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def param_bytes(params: Sequence[torch.Tensor]) -> int:
    return sum(p.numel() * p.element_size() for p in params)


def optimizer_bytes(optimizer: torch.optim.Optimizer) -> int:
    return sum(t.numel() * t.element_size() for s in optimizer.state.values()
               for t in s.values() if torch.is_tensor(t) and t.dim() > 0)


__all__ = ["COLUMN", "MODEL_AXIS", "REPLICATED", "ROW", "SHARDED_BIAS", "TPDense",
           "describe_sharding", "flatten_specs", "gather_state", "grad_norm", "model_layout",
           "nest", "optimizer_bytes", "param_bytes", "place_state_tp", "shard_state",
           "shard_tree_like", "tp_param_specs", "tp_size", "unify_replicated"]

