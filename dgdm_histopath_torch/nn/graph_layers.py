"""Graph message-passing layers on the padded neighbor-list format.

Counterpart of the JAX package's ``nn/graph_layers.py``: ``GraphConvolution``,
``DynamicGraphLayer``, ``AdaptiveGraphPooling`` (compact mode) and
``GraphUNet`` (compact pooling). Inputs are batched, ``[B, N, ...]``.

Message passing has one formulation here, the gather one that the JAX
package runs under ``gather_impl="pallas"``: the key gather of each
``DynamicGraphLayer`` is the ``gather_rows`` kernel and the message sum of
each ``GraphConvolution`` is the ``gather_agg`` kernel (CUDA on the card,
their plain versions on the CPU). The JAX package's other gather
formulations (one-hot adjacency, XLA take) compute the same function.

``band_window=W`` is the banded (Morton-window) formulation: where the
bucket splits into >= 3 blocks of W nodes, neighbor slots outside the
±1-block band of their node are masked off before anything reads the mask,
so messages, the per-edge softmax and the degree normalization all see the
pruned graph. The gather kernels then run on the absolute indices.

The layers take ``nbr_t``, the transposed list of ``nbr_idx`` that both
gather backwards read (``ops/kernels/neighbor_transpose.py``). ``GraphUNet``
builds one per level of a forward that a gradient will be taken through and
hands it to every layer there; a layer called without one leaves it to the
gathers' backwards.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.graph import (
    band_prune,
    compact_top_k_nodes,
    gather_neighbors,
    masked_softmax,
    real_edge_index,
    scatter_nodes,
    symmetric_norm,
)
from ..ops.kernels.gather_agg import weighted_gather_sum
from ..ops.kernels.neighbor_transpose import transpose_for_backward
from .layers import Dense, DenseGeneral, LayerNorm, dropout, gelu


class Neighbors(NamedTuple):
    """Where a layer reads its neighbours' rows from. ``idx`` [B, N, K]
    indexes the rows of ``table(t)`` [B, N_src, F] for each per-node tensor
    t [B, N, F] the layer gathers from (masked slots outside [0, N_src));
    ``norm`` is (edge_norm [B, N, K], self_norm [B, N]) of
    :func:`symmetric_norm` over the whole graph, at these N rows."""

    idx: torch.Tensor
    table: Callable[[torch.Tensor], torch.Tensor]
    norm: Tuple[torch.Tensor, torch.Tensor]


class GraphConvolution(nn.Module):
    """GCN-style convolution with symmetric degree normalization:
    h_i' = n_ii W x_i + Σ_j n_ij (W x_j + W_e e_ij) + b, n = 1/sqrt(d_i d_j).

    The edge term is reassociated by linearity:
    Σ_k w·W_e·e = W_e·(Σ_k w·e), so no [N, K, F] edge tensor is formed.
    """

    def __init__(self, in_features: int, features: int,
                 edge_dim: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 band_window: Optional[int] = None, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.band_window = band_window
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.lin = Dense(in_features, features, bias=False, **dt)
        self.edge_lin = Dense(edge_dim, features, bias=False, **dt) if edge_dim else None
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))

    def forward(self, x, nbr_idx, nbr_mask, edge_attr=None, edge_weight=None, nbr_t=None,
                nbrs: Optional[Neighbors] = None):
        h = self.lin(x)
        if nbrs is None:
            nbr_mask = band_prune(nbr_idx, nbr_mask, self.band_window)
            (norm, self_norm), table = symmetric_norm(nbr_idx, nbr_mask), h
        else:
            (norm, self_norm), table, nbr_idx = nbrs.norm, nbrs.table(h), nbrs.idx
        weight = norm.to(h.dtype)
        if edge_weight is not None:
            weight = weight * edge_weight.to(h.dtype)
        weight = weight * nbr_mask.to(h.dtype)
        agg = weighted_gather_sum(table, nbr_idx, weight.float(), nbr_t).to(h.dtype)
        if self.edge_lin is not None and edge_attr is not None:
            e_sum = (edge_attr.to(h.dtype) * weight[..., None]).sum(-2)
            agg = agg + self.edge_lin(e_sum)
        out = agg + h * self_norm[..., None].to(h.dtype)
        return out + self.bias.to(out.dtype)


class DynamicGraphLayer(nn.Module):
    """Per-edge multi-head attention (q·k with an edge-key term, softmax
    over each node's K slots), two attention-weighted ``GraphConvolution``s,
    then residual + LayerNorm. Returns (out, attn [B, N, K, H]) when asked.
    When not deterministic, dropout falls on the attention weights and
    between the two convolutions. With ``nbrs`` the key gather and both
    convolutions read their neighbours through it (``nbr_idx`` is then
    unused)."""

    def __init__(self, in_features: int, features: int, num_heads: int = 8,
                 edge_dim: Optional[int] = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, band_window: Optional[int] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.band_window = band_window
        if features % num_heads:
            raise ValueError("features must be divisible by num_heads")
        self.features, self.num_heads = features, num_heads
        self.dropout = dropout
        self.compute_dtype = dtype
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.in_proj = Dense(in_features, features, **dt) if in_features != features else None
        self.q_proj = DenseGeneral(features, features, **dt)
        self.k_proj = DenseGeneral(features, features, **dt)
        self.edge_k_proj = DenseGeneral(edge_dim, features, **dt) if edge_dim else None
        # the layer prunes the mask once and hands it to both convolutions
        self.conv1 = GraphConvolution(features, features, edge_dim, **dt)
        self.conv2 = GraphConvolution(features, features, edge_dim, **dt)
        self.norm = LayerNorm(features, **dt)

    def forward(self, x, nbr_idx, nbr_mask, edge_attr=None,
                return_attention: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, nbr_t=None,
                nbrs: Optional[Neighbors] = None):
        heads = (self.num_heads, self.features // self.num_heads)
        if nbrs is not None and self.band_window is not None:
            raise ValueError("a banded layer reads absolute node ids; it takes no nbrs")
        nbr_mask = band_prune(nbr_idx, nbr_mask, self.band_window)
        x_in = self.in_proj(x) if self.in_proj is not None else x
        q = self.q_proj(x_in).unflatten(-1, heads)                 # [B, N, H, D]
        keys = self.k_proj(x_in)
        k_nbr = (gather_neighbors(keys, nbr_idx, nbr_t) if nbrs is None      # [B, N, K, H*D]
                 else gather_neighbors(nbrs.table(keys), nbrs.idx))
        scores = torch.einsum("...nhd,...nkhd->...nkh", q,
                              k_nbr.unflatten(-1, heads)).float()
        if edge_attr is not None and self.edge_k_proj is not None:
            # q·(W_e e + b_e) reassociated so the [N, K, H, D] edge-key tensor
            # is never formed; W_e and b_e are read off the projection as in
            # the JAX package (projection of the identity minus that of zero)
            e_dim = edge_attr.shape[-1]
            eye = torch.eye(e_dim, dtype=x_in.dtype, device=x_in.device)
            w_plus_b = self.edge_k_proj(eye).unflatten(-1, heads)       # [E, H, D]
            b_e = self.edge_k_proj(torch.zeros_like(eye[:1]))[0].unflatten(-1, heads)
            q_we = torch.einsum("...nhd,ehd->...nhe", q, w_plus_b - b_e)
            scores = scores + torch.einsum(
                "...nke,...nhe->...nkh", edge_attr.to(q.dtype), q_we).float()
            q_be = torch.einsum("...nhd,hd->...nh", q, b_e)
            scores = scores + q_be[..., None, :].float()
        scores = scores / math.sqrt(heads[1])
        attn = masked_softmax(scores, nbr_mask[..., None], dim=-2)     # over K
        if not deterministic:
            attn = dropout(attn, self.dropout, generator)
        edge_weight = attn.mean(-1)                                    # [B, N, K]
        h = gelu(self.conv1(x_in, nbr_idx, nbr_mask, edge_attr, edge_weight, nbr_t, nbrs))
        if not deterministic:
            h = dropout(h, self.dropout, generator)
        h = self.conv2(h, nbr_idx, nbr_mask, edge_attr, edge_weight, nbr_t, nbrs)
        out = self.norm(x_in + h)
        if return_attention:
            return out, attn
        return out


class AdaptiveGraphPooling(nn.Module):
    """Top-k node pooling by a learned score, compact mode: the graph is
    physically shrunk to ``max(1, round(ratio·N))`` nodes, edges into
    dropped nodes are removed, and the score gates surviving features.
    Returns the dict of :func:`compact_top_k_nodes` plus ``"score"``."""

    def __init__(self, features: int, ratio: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ratio = ratio
        self.score = Dense(features, 1, dtype=dtype, param_dtype=param_dtype)

    def keep(self, n: int) -> int:
        """The pooled size of a level of ``n`` nodes."""
        return max(1, int(round(self.ratio * n)))

    def gate(self, x):
        """(score [..., N] f32, the score-gated rows [..., N, F]): per node."""
        score = torch.tanh(self.score(x)[..., 0].float())
        return score, x * torch.sigmoid(score).to(x.dtype)[..., None]

    def forward(self, x, node_mask, nbr_idx, nbr_mask, edge_attr=None):
        score, gated = self.gate(x)
        c = compact_top_k_nodes(gated, nbr_idx, nbr_mask, node_mask, score,
                                self.keep(x.shape[-2]), edge_attr)
        c["score"] = score
        return c


class GraphUNet(nn.Module):
    """Encoder/pool/decoder U-Net over graphs with skip connections; each
    level is a ``DynamicGraphLayer`` + compact ``AdaptiveGraphPooling``,
    unpooling scatters rows back (dropped rows return as zeros).

    ``band_window`` bands the full-N levels only (``down0`` and ``up0``, which
    see the original node order); compact pooling orders the survivors by
    score, so a band over the pooled levels would mean nothing."""

    def __init__(self, in_features: int, features: int, depth: int = 2,
                 pool_ratio: float = 0.5, num_heads: int = 8,
                 edge_dim: Optional[int] = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, band_window: Optional[int] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.in_proj = Dense(in_features, features, **dt) if in_features != features else None

        def layer(banded: bool = False):
            return DynamicGraphLayer(features, features, num_heads, edge_dim, dropout,
                                     dtype, band_window if banded else None,
                                     param_dtype=param_dtype)

        for d in range(depth):
            self.add_module(f"down{d}", layer(banded=d == 0))
            self.add_module(f"pool{d}", AdaptiveGraphPooling(features, pool_ratio, **dt))
        self.bottleneck = layer()
        for d in range(depth):
            self.add_module(f"up{d}", layer(banded=d == 0))
        self.out_norm = LayerNorm(features, **dt)

    def forward(self, x, nbr_idx, nbr_mask, node_mask, edge_attr=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None, nbr_t=None):
        """``nbr_t``: nbr_idx's transposed list where the caller has built it;
        the pooled levels' lists are built here, for their indices with the
        edges pooling dropped pointed outside [0, N) (``real_edge_index``)."""
        rand = dict(deterministic=deterministic, generator=generator)
        if self.in_proj is not None:
            x = self.in_proj(x)
        h = x
        idxs, kmask, nodem, ea = nbr_idx, nbr_mask, node_mask, edge_attr
        tr = transpose_for_backward(idxs) if nbr_t is None else nbr_t
        skips, levels = [], []
        for d in range(self.depth):
            h = getattr(self, f"down{d}")(h, idxs, kmask & nodem[..., None], ea, **rand,
                                          nbr_t=tr)
            skips.append(h)
            c = getattr(self, f"pool{d}")(h, nodem, idxs, kmask, ea)
            levels.append((idxs, kmask, nodem, ea, h.shape[-2],
                           c["sel_idx"], c["node_mask"], tr))
            kmask, nodem, ea = c["nbr_mask"], c["node_mask"], c["edge_attr"]
            h, idxs = c["x"], real_edge_index(c["nbr_idx"], kmask & nodem[..., None])
            tr = transpose_for_backward(idxs)
        h = self.bottleneck(h, idxs, kmask & nodem[..., None], ea, **rand, nbr_t=tr)
        for d in reversed(range(self.depth)):
            idxs, kmask, nodem, ea, n_d, sel, sel_valid, tr = levels[d]
            h = scatter_nodes(h, sel, n_d, valid=sel_valid) + skips[d]
            h = getattr(self, f"up{d}")(h, idxs, kmask & nodem[..., None], ea, **rand,
                                        nbr_t=tr)
        out = self.out_norm(h + x)
        return out * node_mask[..., None].to(out.dtype)
