"""Feature, graph, positional and hierarchical encoders (counterpart of the
JAX package's ``models/encoders.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.utils.checkpoint
from torch import nn

from ..nn.attention import MultiHeadAttention, sinusoidal_position_encoding_2d
from ..nn.graph_layers import DynamicGraphLayer
from ..nn.layers import Dense, LayerNorm, dropout, gelu, get_activation
from ..ops.graph import compact_top_k_nodes, masked_global_mean
from ..ops.kernels.neighbor_transpose import transpose_for_backward

__all__ = ["FeatureEncoder", "GraphEncoder", "HierarchicalEncoder", "PositionalEncoder",
           "get_activation"]


class FeatureEncoder(nn.Module):
    """MLP stack (Dense + Norm + Act + Dropout) x N with a residual
    (projected where the width changes)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 activation: str = "gelu", normalization: str = "layer",
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        if normalization not in ("layer", "none"):
            raise ValueError(f"unknown normalization {normalization!r}")
        self.act = get_activation(activation)
        self.dims = list(hidden_dims)
        prev = in_features
        for i, dim in enumerate(self.dims):
            self.add_module(f"dense{i}", Dense(prev, dim, **dt))
            if normalization == "layer":
                self.add_module(f"norm{i}", LayerNorm(dim, **dt))
            if prev != dim:
                self.add_module(f"res_proj{i}", Dense(prev, dim, bias=False, **dt))
            prev = dim

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(len(self.dims)):
            residual = h
            h = getattr(self, f"dense{i}")(h)
            norm = getattr(self, f"norm{i}", None)
            if norm is not None:
                h = norm(h)
            h = self.act(h)
            if not deterministic:
                h = dropout(h, self.dropout, generator)
            proj = getattr(self, f"res_proj{i}", None)
            h = h + (residual if proj is None else proj(residual))
        return h


class GraphEncoder(nn.Module):
    """``num_layers`` DynamicGraphLayers over projected edge features, each
    followed by the activation and dropout, then an output projection.
    ``band_window`` makes every layer banded (``nn/graph_layers.py``).
    Every layer reads one transposed list of ``nbr_idx`` (``nbr_t``, built
    here when the caller has none and a gradient will be taken).

    ``remat`` (the reference's ``nn.remat`` of each layer): where a gradient
    is recorded and no attention is returned, each layer runs under
    ``torch.utils.checkpoint``, so its activations are recomputed in the
    backward instead of kept (:meth:`_checkpointed`). The activation and
    dropout after each layer stay outside, as in the reference.
    With ``nbrs`` (``nn.graph_layers.Neighbors``: a node block's neighbours,
    ``parallel/sp.py``) every layer reads its neighbours through it.
    Returns ``{"embeddings", "layer_outputs"[, "attentions"]}``."""

    def __init__(self, in_features: int, hidden_dim: int, num_layers: int = 4,
                 num_heads: int = 8, edge_dim: Optional[int] = 3,
                 activation: str = "gelu", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, band_window: Optional[int] = None,
                 remat: bool = False, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        self.dropout = dropout
        self.act = get_activation(activation)
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        self.input_proj = Dense(in_features, hidden_dim, **dt)
        e = hidden_dim // num_heads
        self.edge_proj = Dense(edge_dim, e, **dt) if edge_dim else None
        for i in range(num_layers):
            self.add_module(f"layer{i}", DynamicGraphLayer(
                hidden_dim, hidden_dim, num_heads, e if edge_dim else None, dropout,
                dtype, band_window, param_dtype=param_dtype))
        self.output_proj = Dense(hidden_dim, hidden_dim, **dt)

    def forward(self, x, nbr_idx, nbr_mask, node_mask, edge_attr=None,
                return_attention: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, nbr_t=None,
                nbrs=None) -> Dict[str, object]:
        h = self.input_proj(x)
        if nbr_t is None:
            nbr_t = transpose_for_backward(nbr_idx)
        e = None
        if edge_attr is not None and self.edge_proj is not None:
            e = self.edge_proj(edge_attr.to(h.dtype))
        masked_nbr = nbr_mask & node_mask[..., None]
        remat = (self.remat and not return_attention and torch.is_grad_enabled()
                 and (x.requires_grad or any(p.requires_grad for p in self.parameters())))
        layer_outputs, attentions = [], []
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if remat:
                res = self._checkpointed(layer, h, nbr_idx, masked_nbr, e, deterministic,
                                         generator, nbr_t, nbrs)
            else:
                res = layer(h, nbr_idx, masked_nbr, e, return_attention=return_attention,
                            deterministic=deterministic, generator=generator, nbr_t=nbr_t,
                            nbrs=nbrs)
            if return_attention:
                h, attn = res
                attentions.append(attn)
            else:
                h = res
            h = self.act(h)
            if not deterministic:
                h = dropout(h, self.dropout, generator)
            layer_outputs.append(h)
        out = self.output_proj(h) * node_mask[..., None].to(h.dtype)
        result = {"embeddings": out, "layer_outputs": layer_outputs}
        if return_attention:
            result["attentions"] = attentions
        return result

    @staticmethod
    def _checkpointed(layer, h, nbr_idx, nbr_mask, e, deterministic, generator, nbr_t,
                      nbrs=None):
        """``layer`` under a non-reentrant checkpoint. Its dropout draws come
        from ``generator``, whose state ``checkpoint`` does not save (its
        ``preserve_rng_state`` covers only the global generators): the
        recompute sets the generator back to its state before the first run,
        so it draws the same masks, and then puts back the state it found, so
        the draws after the backward are those of a step without remat.
        Dropout from the global generator (``generator=None``) is replayed by
        ``checkpoint`` itself. ``nbr_t`` and ``e`` come in as inputs: the
        recompute builds no list."""
        saved = None if deterministic or generator is None else generator.get_state()
        first = True

        def run(h, nbr_idx, nbr_mask, e, nbr_t):
            nonlocal first
            found = None
            if not first and saved is not None:   # the recompute replays the draws
                found = generator.get_state()
                generator.set_state(saved)
            first = False
            try:
                return layer(h, nbr_idx, nbr_mask, e, deterministic=deterministic,
                             generator=generator, nbr_t=nbr_t, nbrs=nbrs)
            finally:                              # also when the recompute stops early
                if found is not None:
                    generator.set_state(found)

        return torch.utils.checkpoint.checkpoint(run, h, nbr_idx, nbr_mask, e, nbr_t,
                                                 use_reentrant=False,
                                                 preserve_rng_state=(not deterministic
                                                                     and generator is None))


class PositionalEncoder(nn.Module):
    """The 2-D sinusoidal encoding of normalized coordinates, projected:
    pos [..., N, 2] -> [..., N, embed_dim]."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.compute_dtype = dtype
        self.proj = Dense(embed_dim, embed_dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        enc = sinusoidal_position_encoding_2d(pos, self.embed_dim)
        return self.proj(enc.to(self.compute_dtype))


class HierarchicalEncoder(nn.Module):
    """Multi-resolution encoder over distinct coarsened graphs: a
    ``GraphEncoder`` per level, each coarser level attending to the previous
    finer one (``cross_level_attention``), each level mean-pooled over its
    own real nodes, the level vectors concatenated and fused by two Denses
    with a tanh-GELU between. Returns the graph-level vector [B, hidden_dim].

    Two input forms, as in the JAX package:

    * per-level graphs: sequences of ``x / nbr_idx / nbr_mask / node_mask``
      (and ``edge_attr``), exactly ``num_levels`` of them, else
      ``ValueError``; ``in_features`` is then a sequence of each level's
      feature width (one int serves every level);
    * one graph: the coarser levels are derived here, each keeping the
      ``round(N * pooling_ratio)`` nodes of highest degree
      (``compact_top_k_nodes``, a stable sort) with remapped neighbor rows.

    Every level's message passing runs the gather kernels on the card.
    ``edge_dim`` is the width of ``edge_attr``; ``None`` for graphs without
    edge features (the JAX encoder then has no ``edge_proj``)."""

    def __init__(self, in_features: Union[int, Sequence[int]], hidden_dim: int,
                 num_levels: int = 2, num_layers_per_level: int = 2, num_heads: int = 8,
                 edge_dim: Optional[int] = 3, dropout: float = 0.1,
                 pooling_ratio: float = 0.5, cross_level_attention: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_levels, self.pooling_ratio = num_levels, pooling_ratio
        self.cross_level_attention, self.dropout = cross_level_attention, dropout
        widths = ([in_features] * num_levels if isinstance(in_features, int)
                  else list(in_features))
        dt = dict(dtype=dtype, param_dtype=param_dtype)
        for lvl in range(num_levels):
            self.add_module(f"level{lvl}", GraphEncoder(
                widths[lvl], hidden_dim, num_layers_per_level,
                num_heads, edge_dim, dropout=dropout, **dt))
        if cross_level_attention:
            for lvl in range(1, num_levels):
                self.add_module(f"cross{lvl}", MultiHeadAttention(hidden_dim, num_heads,
                                                                  dropout, **dt))
        self.fusion0 = Dense(num_levels * hidden_dim, hidden_dim, **dt)
        self.fusion1 = Dense(hidden_dim, hidden_dim, **dt)

    def levels(self, x, nbr_idx, nbr_mask, node_mask, edge_attr=None) -> list:
        """The per-level graphs, as dicts of ``x, nbr_idx, nbr_mask,
        node_mask, edge_attr``."""
        if isinstance(x, (list, tuple)):
            levels = [dict(x=x[i], nbr_idx=nbr_idx[i], nbr_mask=nbr_mask[i],
                           node_mask=node_mask[i],
                           edge_attr=None if edge_attr is None else edge_attr[i])
                      for i in range(len(x))]
            if len(levels) != self.num_levels:
                raise ValueError(f"got {len(levels)} per-level graphs, expected "
                                 f"num_levels={self.num_levels}")
            return levels
        levels = [dict(x=x, nbr_idx=nbr_idx, nbr_mask=nbr_mask, node_mask=node_mask,
                       edge_attr=edge_attr)]
        for _ in range(1, self.num_levels):
            prev = levels[-1]
            keep = max(1, int(round(prev["x"].shape[-2] * self.pooling_ratio)))
            deg = prev["nbr_mask"].sum(-1).float()
            c = compact_top_k_nodes(prev["x"], prev["nbr_idx"], prev["nbr_mask"],
                                    prev["node_mask"], deg, keep, edge_attr=prev["edge_attr"])
            levels.append({k: c[k] for k in ("x", "nbr_idx", "nbr_mask", "node_mask",
                                             "edge_attr")})
        return levels

    def forward(self, x, nbr_idx, nbr_mask, node_mask, edge_attr=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rand = dict(deterministic=deterministic, generator=generator)
        levels = self.levels(x, nbr_idx, nbr_mask, node_mask, edge_attr)
        embs = [getattr(self, f"level{lvl}")(g["x"], g["nbr_idx"], g["nbr_mask"],
                                            g["node_mask"], g["edge_attr"], **rand)["embeddings"]
                for lvl, g in enumerate(levels)]
        if self.cross_level_attention:
            embs = [embs[0]] + [
                embs[lvl] + getattr(self, f"cross{lvl}")(
                    embs[lvl], embs[lvl - 1], embs[lvl - 1],
                    key_mask=levels[lvl - 1]["node_mask"], **rand)
                for lvl in range(1, self.num_levels)]
        pooled = [masked_global_mean(e, g["node_mask"]) for e, g in zip(embs, levels)]
        h = gelu(self.fusion0(torch.cat(pooled, dim=-1)))
        if not deterministic:
            h = dropout(h, self.dropout, generator)
        return self.fusion1(h)
