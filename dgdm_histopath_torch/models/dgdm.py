"""DGDMModel: the Dynamic Graph Diffusion Model, inference and finetune
forward (counterpart of the JAX package's ``models/dgdm.py``).

FeatureEncoder → GraphEncoder → SpatialAttention → GraphUNet → global
pooling → heads. The constructor takes the JAX model's keyword set, so a
bundle's ``model_config`` builds the same architecture; options this port
does not have yet raise ``NotImplementedError`` naming their ROADMAP item.
The diffusion denoiser, ``mask_token`` and ``recon_head`` are held so that
checkpoints carry over; the pretrain forward comes with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ..nn.attention import SpatialAttention
from ..nn.diffusion import DiffusionLayer
from ..nn.graph_layers import GraphUNet
from ..nn.layers import Dense, as_dtype
from ..ops.graph import PaddedGraph
from ..utils.exceptions import ConfigurationError
from .decoders import ClassificationHead, RegressionHead, SurvivalHead
from .encoders import FeatureEncoder, GraphEncoder
from .pooling import make_pool

# every gather_impl of the JAX package computes the same function; the port
# has one formulation, the gather kernels
GATHER_IMPLS = ("auto", "onehot", "xla", "pallas")


class DGDMModel(nn.Module):
    """Dynamic Graph Diffusion Model for whole-slide tissue graphs."""

    def __init__(
        self,
        node_features: int = 768,
        hidden_dims: Sequence[int] = (512, 256, 128),
        num_diffusion_steps: int = 10,
        attention_heads: int = 8,
        dropout: float = 0.1,
        graph_layers: int = 4,
        use_spatial_attention: bool = True,
        use_hierarchical: bool = True,
        diffusion_schedule: str = "cosine",
        activation: str = "gelu",
        normalization: str = "layer",
        pooling: str = "attention",
        num_classes: Optional[int] = None,
        regression_targets: int = 0,
        survival_mode: Optional[str] = None,
        survival_intervals: int = 10,
        edge_features: int = 3,
        use_remat: bool = False,
        gather_impl: str = "auto",
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        attention_traffic_dtype: Optional[str] = None,
        spatial_window: Optional[int] = None,
        moe_experts: int = 0,
        moe_top_k: int = 1,
        moe_capacity: float = 1.5,
        moe_hidden: Optional[int] = None,
        graph_window: Optional[int] = None,
    ):
        super().__init__()
        for k, v in dict(locals()).items():
            if k not in ("self", "__class__"):
                setattr(self, k, v)
        self.hidden_dims = list(hidden_dims)
        self._validate()
        dtype = as_dtype(compute_dtype)
        self.dtype = dtype
        hidden = hidden_dims[-1]

        self.feature_encoder = FeatureEncoder(node_features, hidden_dims, activation,
                                              normalization, dtype)
        self.graph_encoder = GraphEncoder(hidden, hidden, graph_layers, attention_heads,
                                          edge_features, activation, dtype)
        if use_spatial_attention:
            self.spatial_attention = SpatialAttention(hidden, attention_heads, dtype=dtype)
        if use_hierarchical:
            self.graph_unet = GraphUNet(hidden, hidden, depth=2, num_heads=attention_heads,
                                        edge_dim=edge_features, dtype=dtype)
        self.diffusion = DiffusionLayer(hidden, dtype=dtype)
        self.pool = make_pool(pooling, hidden, attention_heads, dtype=dtype)
        if num_classes is not None:
            self.classification_head = ClassificationHead(hidden, num_classes, (hidden,), dtype)
        if regression_targets > 0:
            self.regression_head = RegressionHead(hidden, regression_targets, (hidden,),
                                                  dtype=dtype)
        if survival_mode is not None:
            self.survival_head = SurvivalHead(hidden, survival_mode, survival_intervals,
                                              (hidden,), dtype)
        self.mask_token = nn.Parameter(torch.zeros(node_features))
        self.recon_head = Dense(hidden, node_features, dtype=dtype)

    def _validate(self) -> None:
        if self.node_features <= 0:
            raise ConfigurationError("node_features must be positive")
        if not self.hidden_dims or any(h <= 0 for h in self.hidden_dims):
            raise ConfigurationError("hidden_dims must be positive")
        if self.hidden_dims[-1] % self.attention_heads != 0:
            raise ConfigurationError("attention_heads must divide hidden_dims[-1]")
        if not 0.0 <= self.dropout < 1.0:
            raise ConfigurationError("dropout must be in [0, 1)")
        if self.diffusion_schedule not in ("linear", "cosine", "sigmoid"):
            raise ConfigurationError("invalid diffusion_schedule")
        if self.attention_traffic_dtype not in (None, "bfloat16", "float32", "float16"):
            raise ConfigurationError(
                "attention_traffic_dtype must be None|bfloat16|float16|float32")
        if self.compute_dtype not in ("bfloat16", "float32", "float16"):
            raise ConfigurationError("compute_dtype must be bfloat16|float16|float32")
        if self.param_dtype not in ("bfloat16", "float32", "float16"):
            raise ConfigurationError("param_dtype must be bfloat16|float16|float32")
        if self.compute_dtype == "float16":
            raise NotImplementedError(
                "compute_dtype='float16' is not ported yet: the gather kernels take "
                "bfloat16 and float32 (ROADMAP queue 1, item 8: model options still "
                "to port)")
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: only float32 parameters are ported "
                "(ROADMAP queue 1, item 7)")
        if self.attention_traffic_dtype is not None:
            raise NotImplementedError(
                f"attention_traffic_dtype={self.attention_traffic_dtype!r} is not ported "
                "yet (ROADMAP queue 1, item 8: model options still to port)")
        if self.gather_impl not in GATHER_IMPLS:
            raise ConfigurationError(f"gather_impl must be one of {GATHER_IMPLS}")
        if self.survival_mode not in (None, "cox", "discrete"):
            raise ConfigurationError("survival_mode must be cox|discrete")
        for name in ("spatial_window", "graph_window"):
            w = getattr(self, name)
            if w is not None and w <= 0:
                raise ConfigurationError(f"{name} must be positive")
            if w is not None:
                raise NotImplementedError(
                    f"{name}={w}: windowed and banded paths are not ported yet "
                    "(ROADMAP queue 1, item 8: model options still to port)")
        if self.moe_experts < 0:
            raise ConfigurationError("moe_experts must be >= 0")
        if self.moe_experts > 0:
            raise NotImplementedError(
                f"moe_experts={self.moe_experts}: the MoE block is not ported yet "
                "(ROADMAP queue 1, item 12: parallel tiers and MoE)")

    def forward(self, graph: PaddedGraph, mode: str = "inference",
                deterministic: bool = True,
                return_attention: bool = False) -> Dict[str, Any]:
        """Forward pass over a batched PaddedGraph (leading B axis)."""
        if mode == "pretrain":
            raise NotImplementedError(
                "the pretrain forward comes with the training slice "
                "(ROADMAP queue 1, item 7)")
        if mode not in ("inference", "finetune"):
            raise ValueError(f"unknown mode {mode!r}")
        if not deterministic and self.dropout > 0.0:
            raise NotImplementedError(
                "the stochastic (dropout) forward comes with the training slice "
                "(ROADMAP queue 1, item 7)")
        x = graph.x.to(self.dtype)
        node_mask = graph.node_mask
        outputs: Dict[str, Any] = {}

        h = self.feature_encoder(x)
        enc = self.graph_encoder(h, graph.nbr_idx, graph.nbr_mask, node_mask,
                                 edge_attr=graph.edge_attr,
                                 return_attention=return_attention)
        h = enc["embeddings"]
        if return_attention:
            outputs["edge_attentions"] = enc["attentions"]

        if self.use_spatial_attention:
            res = self.spatial_attention(h, graph.pos.float(), node_mask,
                                         return_weights=return_attention)
            if return_attention:
                h, outputs["spatial_attention"] = res
            else:
                h = res

        if self.use_hierarchical:
            h = self.graph_unet(h, graph.nbr_idx, graph.nbr_mask, node_mask,
                                edge_attr=graph.edge_attr)
        outputs["node_embeddings"] = h

        if self.pooling == "attention" and return_attention:
            pooled, outputs["attention_weights"] = self.pool(h, node_mask,
                                                             return_weights=True)
        else:
            pooled = self.pool(h, node_mask)
        outputs["graph_embedding"] = pooled

        if self.num_classes is not None:
            outputs["classification_logits"] = self.classification_head(pooled)
        if self.regression_targets > 0:
            outputs["regression"] = self.regression_head(pooled)
        if self.survival_mode is not None:
            outputs["survival"] = self.survival_head(pooled)
        return outputs
