"""DGDMModel: the Dynamic Graph Diffusion Model (counterpart of the JAX
package's ``models/dgdm.py``).

FeatureEncoder → GraphEncoder → (MoE FFN) → SpatialAttention → GraphUNet →
(pretrain: diffusion objective + reconstruction) → global pooling → heads. The
constructor takes the JAX model's keyword set, so a bundle's
``model_config`` builds the same architecture; options this port does not
have yet raise ``NotImplementedError`` naming their ROADMAP item.

Every random draw (dropout masks, diffusion timesteps and noise, entity
masking) comes from the ``torch.Generator`` the caller passes, on the
model's device, or is handed in as a tensor; nothing reads the global
generator.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..nn.attention import SpatialAttention
from ..nn.diffusion import DiffusionLayer
from ..nn.graph_layers import GraphUNet
from ..nn.layers import Dense, LayerNorm, as_dtype
from ..nn.moe import MoEFFN, local_mean
from ..ops.graph import PaddedGraph, real_edge_index
from ..ops.kernels.neighbor_transpose import transpose_for_backward
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
                                              normalization, dropout, dtype)
        self.graph_encoder = GraphEncoder(hidden, hidden, graph_layers, attention_heads,
                                          edge_features, activation, dropout, dtype,
                                          band_window=graph_window, remat=use_remat)
        if moe_experts > 0:
            # pre-norm routed expert FFN, residual, after the message passing
            self.moe_norm = LayerNorm(hidden, dtype)
            self.moe_ffn = MoEFFN(hidden, moe_hidden or 2 * hidden, num_experts=moe_experts,
                                  top_k=moe_top_k, capacity_factor=moe_capacity,
                                  activation=activation, dropout=dropout, dtype=dtype)
        if use_spatial_attention:
            self.spatial_attention = SpatialAttention(
                hidden, attention_heads, dropout, window_size=spatial_window, dtype=dtype,
                traffic_dtype=(None if attention_traffic_dtype is None
                               else as_dtype(attention_traffic_dtype)))
        if use_hierarchical:
            self.graph_unet = GraphUNet(hidden, hidden, depth=2, num_heads=attention_heads,
                                        edge_dim=edge_features, dropout=dropout, dtype=dtype,
                                        band_window=graph_window)
        self.diffusion = DiffusionLayer(hidden, num_diffusion_steps, diffusion_schedule,
                                        dtype=dtype)
        self.pool = make_pool(pooling, hidden, attention_heads, dtype=dtype)
        if num_classes is not None:
            self.classification_head = ClassificationHead(hidden, num_classes, (hidden,),
                                                          dropout, dtype)
        if regression_targets > 0:
            self.regression_head = RegressionHead(hidden, regression_targets, (hidden,),
                                                  dropout, dtype=dtype)
        if survival_mode is not None:
            self.survival_head = SurvivalHead(hidden, survival_mode, survival_intervals,
                                              (hidden,), dropout, dtype)
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
                "bfloat16 and float32 (ROADMAP queue 1, item 8: param_dtype, set2set "
                "and float16 still to port)")
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: only float32 parameters are ported "
                "(ROADMAP queue 1, item 8: param_dtype, set2set and float16 still "
                "to port)")
        if self.gather_impl not in GATHER_IMPLS:
            raise ConfigurationError(f"gather_impl must be one of {GATHER_IMPLS}")
        if self.survival_mode not in (None, "cox", "discrete"):
            raise ConfigurationError("survival_mode must be cox|discrete")
        for name in ("spatial_window", "graph_window"):
            w = getattr(self, name)
            if w is not None and w <= 0:
                raise ConfigurationError(f"{name} must be positive")
        if self.moe_experts < 0:
            raise ConfigurationError("moe_experts must be >= 0")
        if self.moe_experts and self.moe_top_k not in (1, 2):
            raise ConfigurationError("moe_top_k must be 1 or 2")

    def forward(self, graph: PaddedGraph, mode: str = "inference",
                deterministic: bool = True, return_attention: bool = False,
                generator: Optional[torch.Generator] = None,
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                batch_mean: Callable = local_mean,
                moe_group_size: Optional[int] = None) -> Dict[str, Any]:
        """Forward pass over a batched PaddedGraph (leading B axis).

        ``mode``: inference | pretrain | finetune. ``generator`` feeds the
        dropout masks (when not ``deterministic``) and, in pretrain mode,
        the diffusion timesteps ``t`` [B] and ``noise`` [B, N, hidden]
        unless those are given. ``batch_mean(num, count)`` takes the
        batch-mean losses (the diffusion loss, the MoE's aux loss); a
        data-parallel trainer passes one whose count spans every rank, and
        the MoE's routing-group length with ``moe_group_size``.
        """
        if mode not in ("inference", "pretrain", "finetune"):
            raise ValueError(f"unknown mode {mode!r}")
        rand = dict(deterministic=deterministic, generator=generator)
        x = graph.x.to(self.dtype)
        node_mask = graph.node_mask
        outputs: Dict[str, Any] = {}

        h = self.feature_encoder(x, **rand)
        # masked-off slots point outside [0, N) (no forward value changes), and
        # one transposed neighbor list serves the backward of every full-N layer
        nbr_idx = real_edge_index(graph.nbr_idx, graph.nbr_mask & node_mask[..., None])
        nbr_t = transpose_for_backward(nbr_idx)
        enc = self.graph_encoder(h, nbr_idx, graph.nbr_mask, node_mask,
                                 edge_attr=graph.edge_attr,
                                 return_attention=return_attention, **rand, nbr_t=nbr_t)
        h = enc["embeddings"]
        if return_attention:
            outputs["edge_attentions"] = enc["attentions"]

        if self.moe_experts > 0:
            # padded nodes claim no expert capacity and receive zeros
            moe_out, outputs["moe_aux_loss"] = self.moe_ffn(
                self.moe_norm(h), node_mask, **rand, batch_mean=batch_mean,
                group_size=moe_group_size)
            h = h + moe_out

        if self.use_spatial_attention:
            res = self.spatial_attention(h, graph.pos.float(), node_mask,
                                         return_weights=return_attention, **rand)
            if return_attention:
                h, outputs["spatial_attention"] = res
            else:
                h = res

        if self.use_hierarchical:
            h = self.graph_unet(h, nbr_idx, graph.nbr_mask, node_mask,
                                edge_attr=graph.edge_attr, **rand, nbr_t=nbr_t)
        outputs["node_embeddings"] = h

        if mode == "pretrain":
            # diffusion objective on the final embeddings, masked over padding
            predicted, true_noise, t = self.diffusion(h, generator=generator, t=t,
                                                      noise=noise)
            mask_f = node_mask[..., None].float()
            sq = (predicted.float() - true_noise.float()) ** 2
            outputs["diffusion_loss"] = batch_mean((sq * mask_f).sum(),
                                                   mask_f.sum() * sq.shape[-1])
            outputs["diffusion_t"] = t
            outputs["reconstruction"] = self.recon_head(h)

        if self.pooling == "attention" and return_attention:
            pooled, outputs["attention_weights"] = self.pool(h, node_mask,
                                                             return_weights=True)
        else:
            pooled = self.pool(h, node_mask)
        outputs["graph_embedding"] = pooled

        if self.num_classes is not None:
            outputs["classification_logits"] = self.classification_head(pooled, **rand)
        if self.regression_targets > 0:
            outputs["regression"] = self.regression_head(pooled, **rand)
        if self.survival_mode is not None:
            outputs["survival"] = self.survival_head(pooled, **rand)
        return outputs

    def _draw_masked(self, graph: PaddedGraph, mask_ratio: float,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        u = torch.rand(graph.node_mask.shape, generator=generator,
                       device=graph.node_mask.device)
        return (u < mask_ratio) & graph.node_mask

    def apply_entity_masking(self, graph: PaddedGraph, mask_ratio: float = 0.15,
                             generator: Optional[torch.Generator] = None,
                             masked: Optional[torch.Tensor] = None) -> PaddedGraph:
        """Replace a random ``mask_ratio`` of the real nodes (or the nodes of
        ``masked`` [B, N] bool) with the learned mask token."""
        if masked is None:
            masked = self._draw_masked(graph, mask_ratio, generator)
        token = self.mask_token.to(graph.x.dtype)
        return graph.replace(x=torch.where(masked[..., None], token, graph.x))

    def pretrain_step(self, graph: PaddedGraph, mask_ratio: float = 0.15,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      masked: Optional[torch.Tensor] = None,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      batch_mean: Callable = local_mean,
                      moe_group_size: Optional[int] = None) -> Dict[str, Any]:
        """Entity masking + pretrain forward; adds the masked-node
        reconstruction loss and ``masked_nodes`` to the outputs. The draws
        ``masked``, ``t`` and ``noise`` come from ``generator`` unless given."""
        if masked is None:
            masked = self._draw_masked(graph, mask_ratio, generator)
        corrupted = self.apply_entity_masking(graph, masked=masked)
        outputs = self(corrupted, mode="pretrain", deterministic=deterministic,
                       generator=generator, t=t, noise=noise, batch_mean=batch_mean,
                       moe_group_size=moe_group_size)
        m = masked[..., None].float()
        sq = (outputs["reconstruction"].float() - graph.x.float()) ** 2
        outputs["reconstruction_loss"] = batch_mean((sq * m).sum(),
                                                    m.sum() * graph.x.shape[-1])
        outputs["masked_nodes"] = masked
        return outputs

    @torch.no_grad()
    def generate_embeddings(self, graph: PaddedGraph) -> torch.Tensor:
        """Slide-level embeddings without heads."""
        return self(graph, mode="inference", deterministic=True)["graph_embedding"]
