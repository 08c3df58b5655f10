"""Mixture-of-Experts FFN with grouped dense dispatch (counterpart of the
JAX package's ``nn/moe.py``).

Tokens (graph nodes) are split into fixed-size routing groups; each group
has its own expert capacity ``C = ceil(cf · G · k / E)``. Routing, slot
positions and capacity drops are masked one-hot cumulative sums within a
group, so every shape is static. Dispatch and combine are dense
``[g, G, E, C]`` tensors and the expert compute is three batched products
over ``[E, g·C, F]``: the formulation whose rounding matches the reference.

Parameter layouts are the reference's: ``router`` is a ``Dense`` to E
(f32), ``w_in [E, F, H]``, ``b_in [E, H]``, ``w_out [E, H, F]`` and
``b_out [E, F]``. The router runs in f32; padded tokens claim no capacity,
get zero output and carry no weight in the Switch load-balance loss
``E · Σ_e f_e · P_e`` (per group, averaged over the groups with a real
token).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, dropout, get_activation


def local_mean(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``num / max(count, 1)``: a batch mean over this process's rows. A
    data-parallel trainer passes one that takes ``count`` over every rank."""
    return num / count.clamp_min(1.0)


def routing_group(tokens: int, seq_len: int, group_size: int) -> int:
    """The routing-group length for ``tokens`` tokens in sequences of
    ``seq_len``: ``min(group_size, tokens)``, or ``seq_len`` when that does
    not divide ``tokens``."""
    grp = min(group_size, tokens)
    return grp if tokens % grp == 0 else seq_len


class MoEFFN(nn.Module):
    """Top-k routed expert FFN over the token axis: ``x [..., N, F]`` and
    ``token_mask [..., N]`` -> ``(out [..., N, F], aux_loss f32 scalar)``."""

    def __init__(self, features: int, hidden_dim: int, num_experts: int = 8,
                 top_k: int = 1, capacity_factor: float = 1.5, group_size: int = 1024,
                 activation: str = "gelu", dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2")
        self.features, self.hidden_dim = features, hidden_dim
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.act = get_activation(activation)
        self.dropout = dropout
        self.compute_dtype = dtype
        self.router = Dense(features, num_experts, dtype=torch.float32)
        e = num_experts
        self.w_in = nn.Parameter(torch.zeros(e, features, hidden_dim))
        self.b_in = nn.Parameter(torch.zeros(e, hidden_dim))
        self.w_out = nn.Parameter(torch.zeros(e, hidden_dim, features))
        self.b_out = nn.Parameter(torch.zeros(e, features))

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        """flax's lecun-normal for the expert kernels: a kernel [E, in, out]
        has fan-in E·in (the leading axis counts as a receptive field)."""
        for w in (self.w_in, self.w_out):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.b_in.zero_()
        self.b_out.zero_()

    def capacity(self, grp: int) -> int:
        """Per-group expert capacity: a float ceiling division, in [1, grp]."""
        cap = int(-(-self.capacity_factor * grp * self.top_k // self.num_experts))
        return max(1, min(cap, grp))

    def route(self, x: torch.Tensor, token_mask: torch.Tensor,
              group_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The routing of ``x``: ``dispatch`` and ``combine`` [g, G, E, C]
        f32, ``probs`` [g, G, E], ``first_choice`` [g, G, E] (the first
        slot's one-hot, dropped tokens included), ``kept`` [g, G, E] (the
        tokens each expert takes), ``mask`` [g, G] and the tokens ``xg``
        [g, G, F]. ``group_size`` overrides the group length."""
        e_num, f = self.num_experts, self.features
        lead = x.shape[:-1]
        t_tok = math.prod(lead) if lead else 1
        grp = group_size or routing_group(t_tok, x.shape[-2], self.group_size)
        if t_tok % grp:
            raise ValueError(f"routing groups of {grp} do not divide {t_tok} tokens")
        n_grp = t_tok // grp
        xg = x.reshape(n_grp, grp, f)
        mask = token_mask.reshape(n_grp, grp).float()
        cap = self.capacity(grp)

        probs = torch.softmax(self.router(xg.float()), dim=-1)     # [g, G, E]
        remaining = probs
        count_e = torch.zeros(n_grp, e_num, device=x.device)
        slots = []
        first_choice = None
        for _ in range(self.top_k):
            eidx = remaining.argmax(-1)                           # first index on ties
            oh_raw = F.one_hot(eidx, e_num).float() * mask[..., None]
            gate = (remaining * oh_raw).sum(-1)
            if first_choice is None:
                first_choice = oh_raw
            # position in the expert's buffer: kept tokens of earlier slots,
            # then earlier tokens of this slot (an exclusive cumulative sum)
            pos_e = count_e[:, None, :] + torch.cumsum(oh_raw, dim=1) - oh_raw
            pos = (pos_e * oh_raw).sum(-1)
            keep = (pos < cap).float() * mask
            oh = oh_raw * keep[..., None]
            count_e = count_e + oh.sum(1)
            slots.append((oh, gate * keep, pos))
            # the chosen expert leaves the race even when the token was dropped
            remaining = remaining * (1.0 - oh_raw)
        gnorm = sum(s[1] for s in slots).clamp_min(1e-9)
        dispatch = torch.zeros(n_grp, grp, e_num, cap, device=x.device)
        combine = torch.zeros_like(dispatch)
        kept = torch.zeros_like(probs)
        for oh, gate, pos in slots:
            sel = oh[..., None] * F.one_hot(pos.clamp_max(cap - 1).long(), cap
                                            ).float()[..., None, :]
            dispatch = dispatch + sel
            combine = combine + sel * (gate / gnorm)[..., None, None]
            kept = kept + oh
        return {"dispatch": dispatch, "combine": combine, "probs": probs,
                "first_choice": first_choice, "kept": kept, "mask": mask, "xg": xg}

    def forward(self, x: torch.Tensor, token_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                batch_mean: Callable = local_mean, group_size: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch_mean(num, count)`` averages the aux loss over the groups
        with a real token; ``group_size`` overrides the routing group."""
        if x.shape[-1] != self.features:
            raise ValueError(f"x feature dim {x.shape[-1]} != features {self.features}")
        r = self.route(x, token_mask, group_size)
        dt = self.compute_dtype
        xg, mask, probs = r["xg"], r["mask"], r["probs"]
        ein = torch.einsum("gsec,gsf->egcf", r["dispatch"].to(dt), xg.to(dt))
        h = torch.einsum("egcf,efh->egch", ein, self.w_in.to(dt))
        h = self.act(h + self.b_in[:, None, None, :].to(dt))
        if not deterministic:
            h = dropout(h, self.dropout, generator)
        eout = torch.einsum("egch,ehf->egcf", h, self.w_out.to(dt))
        eout = eout + self.b_out[:, None, None, :].to(dt)
        out = torch.einsum("egcf,gsec->gsf", eout, r["combine"].to(dt))

        # Switch load balance over the real tokens, first choice, per group
        real = mask.sum(1)
        n_real = real.clamp_min(1.0)
        frac_tokens = r["first_choice"].sum(1) / n_real[:, None]
        mean_prob = (probs * mask[..., None]).sum(1) / n_real[:, None]
        has_real = (real > 0).float()          # groups of pure padding carry no weight
        per_group = self.num_experts * (frac_tokens * mean_prob).sum(-1)
        aux = batch_mean((per_group * has_real).sum(), has_real.sum())

        out = out * mask[..., None].to(out.dtype)
        return out.reshape(x.shape), aux.float()


__all__ = ["MoEFFN", "local_mean", "routing_group"]
