"""Node-axis sharding, the graph analogue of sequence parallelism
(counterpart of the JAX package's ``parallel/sp.py``).

A rank of a ``(data, model)`` mesh holds ``[B/dp, N/tp, ...]``: its data
index's graphs and its model index's contiguous block of ``N/tp`` nodes.
Per-node work (Dense layers, LayerNorms, elementwise ops) runs on the block
as it is; a neighbour gather needs rows of other blocks, which
``parallel/halo.py`` exchanges. Neighbour indices stay global node ids, as
in the JAX package.

JAX places the leaves on the mesh and lets GSPMD insert the collectives of a
whole ``DGDMModel`` forward; the port has no such compiler, so a
model-level forward over node-sharded inputs is not ported (ROADMAP queue
1, item 12's remainder): the halo tier's ``halo_gather`` and
``sp_graph_conv`` are the node-sharded operations.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.graph import PaddedGraph
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

_NODE_LEAVES = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")


def node_sharding(mesh: Mesh, batch_sharded: bool = True) -> tuple:
    """The layout of ``[B, N, ...]`` graph leaves, as a spec tuple: batch over
    ``data`` (when ``batch_sharded``), nodes over ``model``."""
    return (DATA_AXIS if batch_sharded else None, MODEL_AXIS)


def _rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = t.shape[0] // mesh.size
    return t[mesh.rank * n:(mesh.rank + 1) * n]


def shard_graph_nodes(graph: PaddedGraph, mesh: Mesh, batch_sharded: bool = True
                      ) -> PaddedGraph:
    """This rank's block of a batched ``PaddedGraph``: its data index's
    graphs (when ``batch_sharded``) and its model index's contiguous
    ``N/tp`` nodes of every per-node leaf, ``nbr_idx`` still holding global
    node ids. Labels follow the batch rows. Raises ``ValueError`` when the
    node bucket does not divide by the ``model`` size."""
    n = graph.x.shape[1]
    axis = mesh.axis(MODEL_AXIS)
    if n % axis.size:
        raise ValueError(f"node bucket {n} not divisible by model axis {axis.size}")
    n_loc = n // axis.size
    rows = (lambda t: _rows(t, mesh)) if batch_sharded else (lambda t: t)
    fields = {}
    for f in _NODE_LEAVES:
        t = getattr(graph, f)
        fields[f] = None if t is None else rows(t)[:, axis.index * n_loc:(axis.index + 1) * n_loc]
    fields["y"] = None if graph.y is None else rows(graph.y)
    return PaddedGraph(**fields)


def constrain_nodes(hidden: Any, mesh: Any = None) -> Any:
    """The identity. In JAX it pins ``[B, N, F]`` activations to the
    node-sharded layout inside ``jit``; eager PyTorch has no layout to pin: a
    rank's tensor already is its block."""
    return hidden


__all__ = ["constrain_nodes", "node_sharding", "shard_graph_nodes"]
