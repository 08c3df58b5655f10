"""Feature and graph encoders (counterpart of the JAX package's
``models/encoders.py`` ``FeatureEncoder`` and ``GraphEncoder``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.utils.checkpoint
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
