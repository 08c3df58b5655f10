"""Training losses for DGDM pretraining and finetuning (counterpart of the
JAX package's ``training/losses.py``): noise-prediction loss, InfoNCE over
in-batch nodes, masked-entity cross entropy, edge reconstruction with
negative sampling, and Kendall uncertainty weighting.

Pure functions over padded, batched tensors; every reduction is mask-correct
(padding contributes zero) and accumulates in float32. Random draws come as
tensors or from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.graph import gather_neighbors

CONTRASTIVE_NODES = 64      # nodes a graph brings into the InfoNCE similarity matrix


def diffusion_loss(predicted_noise: torch.Tensor, true_noise: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, loss_type: str = "mse",
                   huber_delta: float = 1.0) -> torch.Tensor:
    """Noise-prediction loss (mse/mae/huber), masked over padding nodes."""
    err = predicted_noise.float() - true_noise.float()
    if loss_type == "mse":
        per = err ** 2
    elif loss_type == "mae":
        per = err.abs()
    elif loss_type == "huber":
        abs_err = err.abs()
        quad = abs_err.clamp_max(huber_delta)
        per = 0.5 * quad ** 2 + huber_delta * (abs_err - quad)
    else:
        raise ValueError(f"unknown diffusion loss type {loss_type!r}")
    if mask is None:
        return per.mean()
    m = mask.float()
    while m.dim() < per.dim():
        m = m[..., None]
    return (per * m).sum() / (m.sum() * (per.numel() / m.numel())).clamp_min(1.0)


def contrastive_loss(node_embeddings: torch.Tensor, node_mask: torch.Tensor,
                     temperature: float = 0.1,
                     max_nodes_per_graph: int = CONTRASTIVE_NODES,
                     uniform: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     gather: Optional[Callable] = None) -> torch.Tensor:
    """InfoNCE: nodes of the same graph are positives, nodes of the other
    graphs in the batch are negatives. node_embeddings [B, N, F], node_mask
    [B, N].

    At most ``max_nodes_per_graph`` nodes per graph enter the similarity
    matrix: the top-m of ``2·mask + u``, so real nodes always outrank
    padding. ``u`` is ``uniform`` [B, N] in [0, 1) when given, else drawn
    from ``generator`` when given, else absent: then the choice is the
    first real nodes (equal scores keep the lower index, by a stable sort).

    ``gather`` (data parallelism) stacks every rank's subsampled nodes in
    rank order, with a gradient: the negatives then come from the global
    batch and the loss is the global batch's.
    """
    b, n, f = node_embeddings.shape
    m = min(n, max_nodes_per_graph)
    if m < n:
        score = node_mask.float() * 2.0
        if uniform is None and generator is not None:
            uniform = torch.rand((b, n), generator=generator, device=score.device)
        if uniform is not None:
            score = score + uniform
        sel = torch.argsort(-score, dim=-1, stable=True)[..., :m]
        emb = torch.gather(node_embeddings, 1, sel[..., None].expand(b, m, f)).float()
        mask = torch.gather(node_mask, 1, sel)
    else:
        emb, mask = node_embeddings.float(), node_mask

    flat = emb.reshape(b * m, f)
    flat_mask = mask.reshape(b * m)
    if gather is not None:
        flat, flat_mask = gather(flat), gather(flat_mask)
        b = flat.shape[0] // m
    unit = flat / (flat * flat).sum(-1, keepdim=True).clamp_min(1e-12).sqrt()
    sim = unit @ unit.T / temperature

    graph_id = torch.arange(b, device=flat.device).repeat_interleave(m)
    eye = torch.eye(b * m, dtype=torch.bool, device=flat.device)
    valid = flat_mask[:, None] & flat_mask[None, :] & ~eye
    pos_mask = (graph_id[:, None] == graph_id[None, :]) & valid

    logits = torch.where(valid, sim, torch.full_like(sim, torch.finfo(torch.float32).min))
    log_denom = torch.logsumexp(logits, dim=-1)
    pos_logp = torch.where(pos_mask, sim - log_denom[:, None], torch.zeros_like(sim))
    pos_count = pos_mask.float().sum(-1)
    anchor_ok = (flat_mask & (pos_count > 0)).float()
    per_anchor = -pos_logp.sum(-1) / pos_count.clamp_min(1.0)
    return (per_anchor * anchor_ok).sum() / anchor_ok.sum().clamp_min(1.0)


def contrastive_loss_pairs(anchor: torch.Tensor, positive: torch.Tensor,
                           temperature: float = 0.1) -> torch.Tensor:
    """Explicit-pair InfoNCE: anchor [P, F] against positive [P, F]."""
    a, p = anchor.float(), positive.float()
    a = a / (a * a).sum(-1, keepdim=True).clamp_min(1e-12).sqrt()
    p = p / (p * p).sum(-1, keepdim=True).clamp_min(1e-12).sqrt()
    logits = a @ p.T / temperature
    return -F.log_softmax(logits, dim=-1).diagonal().mean()


def masked_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   masked: torch.Tensor) -> torch.Tensor:
    """Cross entropy over masked-entity predictions: logits [B, N, V],
    targets [B, N] int, masked [B, N] bool (the positions that were masked)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    m = masked.float()
    return -(picked * m).sum() / m.sum().clamp_min(1.0)


def graph_reconstruction_loss(node_embeddings: torch.Tensor, nbr_idx: torch.Tensor,
                              nbr_mask: torch.Tensor, node_mask: torch.Tensor,
                              neg_idx: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              num_negatives: int = 1,
                              focal_gamma: float = 0.0) -> torch.Tensor:
    """Edge-existence BCE with random negative sampling; the edge score is
    dot(h_i, h_j). ``neg_idx`` [B, N, K·num_negatives] int32 holds the
    negative endpoints when given, else they are drawn from ``generator``."""
    b, n, _ = node_embeddings.shape
    k = nbr_idx.shape[-1]
    h = node_embeddings.float().contiguous()
    if neg_idx is None:
        neg_idx = torch.randint(0, n, (b, n, k * num_negatives), generator=generator,
                                device=h.device, dtype=torch.int32)
    pos_logits = torch.einsum("bnf,bnkf->bnk", h, gather_neighbors(h, nbr_idx.contiguous()))
    neg_logits = torch.einsum("bnf,bnkf->bnk", h, gather_neighbors(h, neg_idx.contiguous()))

    def bce(logits, target):
        ce = target * F.softplus(-logits) + (1 - target) * F.softplus(logits)
        if focal_gamma > 0.0:
            p = torch.sigmoid(logits)
            pt = target * p + (1 - target) * (1 - p)
            ce = ce * (1 - pt) ** focal_gamma
        return ce

    pos_m = (nbr_mask & node_mask[..., None]).float()
    neg_m = node_mask[..., None].float().expand(b, n, k * num_negatives)
    pos_term = (bce(pos_logits, 1.0) * pos_m).sum() / pos_m.sum().clamp_min(1.0)
    neg_term = (bce(neg_logits, 0.0) * neg_m).sum() / neg_m.sum().clamp_min(1.0)
    return pos_term + neg_term


def multi_task_loss(losses: torch.Tensor, log_vars: torch.Tensor) -> torch.Tensor:
    """Kendall-style uncertainty weighting over a vector of task losses."""
    return (torch.exp(-log_vars) * losses.float() + 0.5 * log_vars).sum()
