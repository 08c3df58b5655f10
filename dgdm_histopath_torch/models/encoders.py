"""Feature and graph encoders (counterpart of the JAX package's
``models/encoders.py`` ``FeatureEncoder`` and ``GraphEncoder``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..nn.graph_layers import DynamicGraphLayer
from ..nn.layers import Dense, LayerNorm, dropout, get_activation
from ..ops.kernels.neighbor_transpose import transpose_for_backward

__all__ = ["FeatureEncoder", "GraphEncoder", "get_activation"]


class FeatureEncoder(nn.Module):
    """MLP stack (Dense + Norm + Act + Dropout) x N with a residual
    (projected where the width changes)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 activation: str = "gelu", normalization: str = "layer",
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        if normalization not in ("layer", "none"):
            raise ValueError(f"unknown normalization {normalization!r}")
        self.act = get_activation(activation)
        self.dims = list(hidden_dims)
        prev = in_features
        for i, dim in enumerate(self.dims):
            self.add_module(f"dense{i}", Dense(prev, dim, dtype=dtype))
            if normalization == "layer":
                self.add_module(f"norm{i}", LayerNorm(dim, dtype=dtype))
            if prev != dim:
                self.add_module(f"res_proj{i}", Dense(prev, dim, bias=False, dtype=dtype))
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
    Returns ``{"embeddings", "layer_outputs"[, "attentions"]}``."""

    def __init__(self, in_features: int, hidden_dim: int, num_layers: int = 4,
                 num_heads: int = 8, edge_dim: Optional[int] = 3,
                 activation: str = "gelu", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, band_window: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.act = get_activation(activation)
        self.input_proj = Dense(in_features, hidden_dim, dtype=dtype)
        e = hidden_dim // num_heads
        self.edge_proj = Dense(edge_dim, e, dtype=dtype) if edge_dim else None
        for i in range(num_layers):
            self.add_module(f"layer{i}", DynamicGraphLayer(
                hidden_dim, hidden_dim, num_heads, e if edge_dim else None, dropout,
                dtype, band_window))
        self.output_proj = Dense(hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x, nbr_idx, nbr_mask, node_mask, edge_attr=None,
                return_attention: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, nbr_t=None) -> Dict[str, object]:
        h = self.input_proj(x)
        if nbr_t is None:
            nbr_t = transpose_for_backward(nbr_idx)
        e = None
        if edge_attr is not None and self.edge_proj is not None:
            e = self.edge_proj(edge_attr.to(h.dtype))
        masked_nbr = nbr_mask & node_mask[..., None]
        layer_outputs, attentions = [], []
        for i in range(self.num_layers):
            res = getattr(self, f"layer{i}")(h, nbr_idx, masked_nbr, e,
                                             return_attention=return_attention,
                                             deterministic=deterministic,
                                             generator=generator, nbr_t=nbr_t)
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
