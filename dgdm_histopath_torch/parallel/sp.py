"""Node-axis sharding, the graph analogue of sequence parallelism
(counterpart of the JAX package's ``parallel/sp.py``).

A rank of a ``(data, model)`` mesh holds ``[B/dp, N/tp, ...]``: its data
index's graphs and its model index's contiguous block of ``N/tp`` nodes.
Neighbour indices stay global node ids, as in the JAX package.

JAX places the leaves on the mesh and lets GSPMD insert the collectives of a
whole ``DGDMModel`` forward. PyTorch has no such compiler, so
:func:`sp_forward` writes each of them out, over the rank's ``model`` line:

* per-node work (Dense layers, LayerNorms, the per-edge softmax over K, the
  heads' inputs) runs on the block as it is;
* the graph's structure (neighbour ids, masks, edge features: K values a
  node) is all-gathered once; every rank then computes the degree
  normalization and the U-Net's selection of the whole graph, as one
  process does;
* at the full-N levels (the encoder's layers, the U-Net's ``down0`` and
  ``up0``) every neighbour gather reads a ``[local || halo]`` table
  (``halo.halo_table`` over the batch's ``HaloPlan``, one exchange a
  table: the key table and each convolution's features), rectangular for
  the gather kernels;
* spatial attention keeps its queries local and all-gathers the keys,
  values, positions and node mask: ``[b, H, N/tp, N]`` scores a rank;
* U-Net pooling all-gathers the score and the gated rows; every rank runs
  the one-process compaction (the same stable argsort, ``keep`` of the
  whole level) and keeps its contiguous block of pooled positions. Compact
  pooling orders the survivors by score, not by space, so a pooled level's
  neighbours lie in every block: its layers take the whole level's table
  by one all-gather (a square table). Unpooling scatters the gathered
  pooled rows into the rank's own block of the level above;
* the readout: the attention pool's logits are all-gathered for the
  softmax over all N and the weighted sums all-reduced (mean: sums and
  counts; max: the blocks' maxima); the heads run on every rank.

It trains as well (``mode="pretrain" | "finetune"``, dropout on), the
counterpart of JAX ``DGDMTrainer.training_step(shard_graph_nodes(batch,
mesh), prepared=True)``, where GSPMD makes every collective differentiable.
Here each collective above is the summed-loss one of ``mesh.py``
(``all_gather``, ``all_reduce``, ``all_to_all``): every rank holds its part
of a loss that is the sum over the ranks of the line, and the backward of
each collective is its exact adjoint. The loss convention that goes with
it (the trainer's): a per-node term (the diffusion and reconstruction sums)
is this rank's partial sum over the counts of the whole line, and a term
every rank computes alike (InfoNCE over the line-gathered embeddings, the
heads' losses on the readout) is divided by the line's size; the
parameters' gradients are then summed over the line. Each level builds the
transposed lists its gathers' backwards read once: the ``[local || halo]``
table's (``n_loc + tp·H`` rows) and the outgoing rows' (``n_loc``) at the
full-N levels, the whole level's (N') at the pooled ones. Dropout draws
each mask at the whole graph's shape and keys each row to its node
(``nn.layers.NodeRows``: the block's nodes at the full-N levels, the
composed selections at the pooled ones, as one process keys them), and the
diffusion draws and the entity mask come at the whole graph's shape, so a
rank drops, masks and noises what one process does, also where two nodes
whose pooling scores tie to rounding swap slots. The options it does not cover raise (ROADMAP item 12).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..nn.graph_layers import Neighbors
from ..nn.layers import NodeRows
from ..nn.moe import local_mean
from ..ops.diffusion import randn_like
from ..ops.graph import (
    PaddedGraph,
    compact_top_k_nodes,
    masked_global_max,
    masked_softmax,
    real_edge_index,
    scatter_nodes,
    symmetric_norm,
)
from ..ops.kernels.neighbor_transpose import transpose_for_backward
from .halo import HaloPlan, halo_table, local_plan
from .mesh import DATA_AXIS, MODEL_AXIS, Axis, Mesh, all_gather, all_reduce
from .tp import whole_weights

_NODE_LEAVES = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")
_QUEUED = "ROADMAP queue 1, item 12: the node-sharded forward does not cover them yet"


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
    node-sharded layout inside ``jit``; in eager PyTorch a rank's tensor
    already is its block, and :func:`sp_forward` keeps it so."""
    return hidden


# ---------------------------------------------------------------------------
# the model forward over a node block
# ---------------------------------------------------------------------------

def _line_gather(axis: Axis) -> Callable[[torch.Tensor], torch.Tensor]:
    """Every rank's block of a per-node tensor [b, n, ...], concatenated
    along the node axis in index order: a float tensor with the summed-loss
    gradient (``mesh.all_gather``), a bool one through uint8."""
    def gather(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.bool:
            return axis.all_gather(t.to(torch.uint8).contiguous(), 1).bool()
        if not t.is_floating_point():
            return axis.all_gather(t.contiguous(), 1)
        return all_gather(t.contiguous(), axis, 1)
    return gather


def line_mean(axis: Axis, inner: Callable = local_mean) -> Callable:
    """A ``batch_mean(num, count)`` over a node block: ``count`` summed over
    ``axis`` first (the line's nodes make one graph), then ``inner`` (a
    data-parallel trainer's takes it over the data ranks), so that each
    rank's ``num`` is its share of the whole mean."""
    def mean(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        return inner(num, axis.all_reduce_(count.detach().float().clone()))
    return mean


class _Level(NamedTuple):
    """One level of the forward on this rank: the whole level's structure
    (replicated: neighbour ids with masked slots -1, the neighbour and node
    masks, edge features), this rank's rows ``[lo, lo + n)`` and how its
    layers read their neighbours."""

    idx: torch.Tensor
    kmask: torch.Tensor
    nodem: torch.Tensor
    ea: Optional[torch.Tensor]
    lo: int
    n: int
    nbrs: Neighbors

    def rows(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t[:, self.lo:self.lo + self.n]


def _level(idx, kmask, nodem, ea, axis: Axis, table, local_idx=None,
           rows: Optional[int] = None) -> _Level:
    """A level from its whole structure; ``local_idx`` indexes ``table``, of
    ``rows`` rows (default: this rank's rows of ``idx``, for a table of the
    whole level). Its transposed list is built here when a gradient will be
    taken (on the card)."""
    n = idx.shape[1] // axis.size
    lo = axis.index * n
    norm = tuple(t[:, lo:lo + n].contiguous()
                 for t in symmetric_norm(idx, kmask & nodem[..., None]))
    # the gather kernels take contiguous indices
    mine = (idx[:, lo:lo + n] if local_idx is None else local_idx).contiguous()
    nbr_t = transpose_for_backward(mine, idx.shape[1] if rows is None else rows)
    return _Level(idx, kmask, nodem, ea, lo, n, Neighbors(mine, table, norm, nbr_t))


def _layer(layer, h: torch.Tensor, lvl: _Level, rand: dict) -> torch.Tensor:
    mask = lvl.rows(lvl.kmask & lvl.nodem[..., None])
    return layer(h, lvl.nbrs.idx, mask, lvl.rows(lvl.ea), nbrs=lvl.nbrs, **rand)


def level_sizes(model, n: int) -> list:
    """The node count of each level of ``model``'s forward on a bucket of n."""
    sizes = [n]
    if model.use_hierarchical:
        for d in range(model.graph_unet.depth):
            sizes.append(getattr(model.graph_unet, f"pool{d}").keep(sizes[-1]))
    return sizes


def _check_options(model, mode: str, return_attention: bool) -> None:
    if mode not in ("inference", "pretrain", "finetune"):
        raise ValueError(f"unknown mode {mode!r}")
    refused = []
    if return_attention:
        refused.append("return_attention=True")
    if model.moe_experts > 0:
        refused.append("moe_experts > 0")
    if model.spatial_window is not None or model.graph_window is not None:
        refused.append("spatial_window / graph_window (DGDM-Large)")
    if model.use_spatial_attention and model.spatial_attention.use_flash:
        refused.append("use_flash")
    if model.use_remat and torch.is_grad_enabled():
        # a checkpointed layer's recompute would run its halo exchanges again
        refused.append("use_remat under a gradient")
    if refused:
        raise NotImplementedError(f"sp_forward: {', '.join(refused)} not ported ({_QUEUED})")


def _unet(unet, x: torch.Tensor, top: _Level, gather, axis: Axis, rand: dict) -> tuple:
    """``GraphUNet`` on this rank's block: its output rows and the selection
    [b, keep] of every pooled level. ``rand`` keys the first level's dropout
    masks to the block's nodes; a pooled level's go to its rows' nodes of the
    first level, as ``GraphUNet.forward`` keys them."""
    if unet.in_proj is not None:
        x = unet.in_proj(x)
    h, lvl = x, top
    skips, levels, ids = [], [], None
    for d in range(unet.depth):
        h = _layer(getattr(unet, f"down{d}"), h, lvl, rand)
        skips.append(h)
        pool = getattr(unet, f"pool{d}")
        score, gated = pool.gate(h)
        c = compact_top_k_nodes(gather(gated), lvl.idx, lvl.kmask, lvl.nodem, gather(score),
                                pool.keep(lvl.idx.shape[1]), lvl.ea)
        levels.append((lvl, c["sel_idx"], c["node_mask"], rand))
        kmask, nodem = c["nbr_mask"], c["node_mask"]
        lvl = _level(real_edge_index(c["nbr_idx"], kmask & nodem[..., None]), kmask, nodem,
                     c["edge_attr"], axis, gather)
        h = lvl.rows(c["x"])
        ids = c["sel_idx"] if ids is None else torch.gather(ids, -1, c["sel_idx"])
        rand = dict(rand, rows=NodeRows(top.idx.shape[1], ids=lvl.rows(ids)))
    h = _layer(unet.bottleneck, h, lvl, rand)
    for d in reversed(range(unet.depth)):
        lvl, sel, valid, rand = levels[d]
        # the pooled rows that land in this block; the others go to row n, dropped
        local = sel - lvl.lo
        inside = (local >= 0) & (local < lvl.n)
        up = scatter_nodes(gather(h), torch.where(inside, local, lvl.n), lvl.n + 1,
                           valid=valid & inside)[:, :lvl.n]
        h = _layer(getattr(unet, f"up{d}"), up + skips[d], lvl, rand)
    out = unet.out_norm(h + x)
    return out * top.rows(top.nodem)[..., None].to(out.dtype), [s for _, s, _, _ in levels]


def _readout(model, h: torch.Tensor, top: _Level, gather, axis: Axis) -> torch.Tensor:
    """The global pool over all N of the blocks: [b, F] on every rank."""
    node_mask = top.rows(top.nodem)
    if model.pooling == "max":
        return gather(masked_global_max(h, node_mask)[:, None]).amax(1)
    if model.pooling == "mean":
        m = node_mask.to(h.dtype)[..., None]
        total = all_reduce((h * m).sum(-2).contiguous(), axis)
        return total / axis.all_reduce_(m.sum(-2).contiguous()).clamp_min(1.0)
    if model.pooling == "set2set":
        # its LSTM's attention rounds read every node: the level, gathered whole
        return model.pool(gather(h), top.nodem)
    pool = model.pool
    logits, v = pool.logits_values(h)
    weights = top.rows(masked_softmax(gather(logits), top.nodem[..., None], dim=-2))
    pooled = torch.einsum("...nh,...nhd->...hd", weights.to(v.dtype), v)
    return pool.out_proj(all_reduce(pooled.contiguous(), axis).flatten(-2))


def _block_rows(t: Optional[torch.Tensor], axis: Axis, n_loc: int) -> Optional[torch.Tensor]:
    """This rank's node block of a [b, N, ...] tensor of the whole graph."""
    return None if t is None else t[:, axis.index * n_loc:(axis.index + 1) * n_loc]


def sp_forward(model, block: PaddedGraph, plan: HaloPlan, mesh: Mesh,
               mode: str = "inference", deterministic: bool = True,
               return_attention: bool = False, generator: Optional[torch.Generator] = None,
               t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
               batch_mean: Optional[Callable] = None) -> Dict[str, Any]:
    """``DGDMModel.forward`` over node-sharded inputs: what ``model(batch,
    mode, deterministic, ...)`` computes, with every rank of the mesh holding
    its block ``block = shard_graph_nodes(batch, mesh)`` and the host-built
    ``plan = halo.build_halo_plan(batch.nbr_idx, batch.nbr_mask, tp)`` of the
    whole batch (Morton-sorted graphs, ``halo.spatial_sort``, keep the halo
    small). ``model`` holds the whole parameters on the block's device, or a
    trainer's tensor-parallel shards of them (gathered whole for the call,
    ``tp.whole_weights``).

    Returns the model's output dict: the heads' outputs and
    ``graph_embedding`` equal on every rank of a line, ``node_embeddings``
    (and in pretrain mode ``reconstruction``) this rank's block, and
    ``pool_sel_idx``, each pooled level's selection [b, keep] (node ids of
    the level above). Pretrain mode adds ``diffusion_loss``, this rank's
    share of the mean through ``batch_mean`` (default: the counts of the
    line, ``line_mean``), and ``diffusion_t``; its ``t`` [b] and ``noise``
    [b, N, hidden] are given for the whole graph or drawn from ``generator``
    at that shape, as one process draws them. Dropout, when not
    ``deterministic``, draws from ``generator`` too. A gradient flows through
    every collective (the summed-loss convention, see the module note).
    Every level's node count must divide by the ``model`` size
    (``ValueError``); returned attention, MoE, windows, flash attention and
    remat under a gradient raise ``NotImplementedError`` (ROADMAP item 12)."""
    _check_options(model, mode, return_attention)
    axis = mesh.axis(MODEL_AXIS)
    n_loc = block.x.shape[1]
    if plan.tp != axis.size or plan.n_local != n_loc:
        raise ValueError(f"plan for tp={plan.tp}, {plan.n_local} rows a block; the mesh's "
                         f"model axis is {axis.size} and the block has {n_loc} rows")
    for size in level_sizes(model, n_loc * axis.size):
        if size % axis.size:
            raise ValueError(f"a level of {size} nodes is not divisible by model axis "
                             f"{axis.size}")
    gather = _line_gather(axis)
    rand = dict(deterministic=deterministic, generator=generator)
    # the first level's dropout masks: this block's nodes of the whole graph
    block_rand = dict(rand, rows=NodeRows(n_loc * axis.size, lo=axis.index * n_loc))
    send, idx = local_plan(plan, mesh, device=block.x.device)
    if idx.shape[:2] != block.nbr_idx.shape[:2]:
        raise ValueError(f"block {tuple(block.nbr_idx.shape)} does not match its plan part "
                         f"{tuple(idx.shape)}")
    with whole_weights():
        node_mask = block.node_mask
        masked = block.nbr_mask & node_mask[..., None]
        ea = block.edge_attr
        send_t = transpose_for_backward(send, n_loc)
        top = _level(gather(real_edge_index(block.nbr_idx, masked)), gather(block.nbr_mask),
                     gather(node_mask), None if ea is None else gather(ea), axis,
                     lambda x: halo_table(x, send, axis, send_t), real_edge_index(idx, masked),
                     n_loc + axis.size * plan.halo_size)

        h = model.feature_encoder(block.x.to(model.dtype), **block_rand)
        h = model.graph_encoder(h, top.nbrs.idx, block.nbr_mask, node_mask, edge_attr=ea,
                                nbrs=top.nbrs, **block_rand)["embeddings"]
        if model.use_spatial_attention:
            h = model.spatial_attention(h, block.pos.float(), node_mask, keys=gather,
                                        **block_rand)
        selections = []
        if model.use_hierarchical:
            h, selections = _unet(model.graph_unet, h, top, gather, axis, block_rand)
        outputs: Dict[str, Any] = {"node_embeddings": h}
        if mode == "pretrain":
            # the whole graph's draws, in one process's order (t, then the noise)
            diff = model.diffusion
            if t is None:
                t = torch.randint(0, diff.num_steps, h.shape[:1], generator=generator,
                                  device=h.device)
            if noise is None:
                noise = randn_like(h.new_empty(h.shape[0], n_loc * axis.size, h.shape[-1]),
                                   generator)
            predicted, true_noise, t = diff(h, t=t, noise=_block_rows(noise, axis, n_loc))
            mask_f = node_mask[..., None].float()
            sq = (predicted.float() - true_noise.float()) ** 2
            mean = batch_mean or line_mean(axis)
            outputs["diffusion_loss"] = mean((sq * mask_f).sum(), mask_f.sum() * sq.shape[-1])
            outputs["diffusion_t"] = t
            outputs["reconstruction"] = model.recon_head(h)
        pooled = _readout(model, h, top, gather, axis)
        outputs.update(graph_embedding=pooled, **model.heads(pooled, **rand),
                       pool_sel_idx=selections)
        return outputs


def sp_pretrain_step(model, block: PaddedGraph, plan: HaloPlan, mesh: Mesh,
                     mask_ratio: float = 0.15, deterministic: bool = False,
                     generator: Optional[torch.Generator] = None,
                     masked: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     batch_mean: Optional[Callable] = None) -> Dict[str, Any]:
    """``DGDMModel.pretrain_step`` over node-sharded inputs: entity masking,
    then :func:`sp_forward` in pretrain mode, and the masked-node
    reconstruction loss (this rank's share, through ``batch_mean``).
    ``masked`` [b, N] is given for the whole graph or drawn from
    ``generator`` at that shape; ``masked_nodes`` comes back as this rank's
    block of it."""
    axis = mesh.axis(MODEL_AXIS)
    n_loc = block.x.shape[1]
    if masked is None:
        masked = torch.rand((block.x.shape[0], n_loc * axis.size), generator=generator,
                            device=block.x.device) < mask_ratio
    masked = _block_rows(masked, axis, n_loc) & block.node_mask
    corrupted = model.apply_entity_masking(block, masked=masked)
    mean = batch_mean or line_mean(axis)
    outputs = sp_forward(model, corrupted, plan, mesh, mode="pretrain",
                         deterministic=deterministic, generator=generator, t=t, noise=noise,
                         batch_mean=mean)
    m = masked[..., None].float()
    sq = (outputs["reconstruction"].float() - block.x.float()) ** 2
    outputs["reconstruction_loss"] = mean((sq * m).sum(), m.sum() * block.x.shape[-1])
    outputs["masked_nodes"] = masked
    return outputs


def whole_node_mask(block: PaddedGraph, mesh: Mesh) -> torch.Tensor:
    """The whole graphs' node mask [b, N] from every rank's block."""
    return _line_gather(mesh.axis(MODEL_AXIS))(block.node_mask)


__all__ = ["constrain_nodes", "level_sizes", "line_mean", "node_sharding", "shard_graph_nodes",
           "sp_forward", "sp_pretrain_step", "whole_node_mask"]
