"""Int8 (w8a8) forward of the ViT featurizer: the JAX package's
``models/vit_int8.py`` on the port.

:func:`quantize_vit_params` quantizes a :class:`~.vit.VisionTransformer`'s
block products once per weight load; :func:`vit_int8_forward` runs the
encoder on them. Per block, the query / key / value projections run as one
int8 product (their per-column weight scales and the one per-row activation
scale make it equal to three), then the output projection and the two MLP
products. The rest follows the JAX function's numerics, not the float
module's:

* the patch embedding: bf16 operands, f32 products and sums, f32 bias;
* ``q / sqrt(Dh)`` in f32, the score and value products on bf16 operands
  with f32 sums, an f32 softmax;
* LayerNorm in f32 with eps 1e-6, the exact (erf) GELU;
* the CLS row of the final LayerNorm, in f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.quant import int8_dense, quantize_weight

Params = Dict[str, Any]


def _q(weight: torch.Tensor, bias: torch.Tensor) -> Params:
    """A ``Dense.weight [N, K]`` -> int8 ``q [N, K]``, scales ``s [N]`` and the
    f32 bias."""
    w_q, scale = quantize_weight(weight, axis=0)
    return {"q": w_q.contiguous(), "s": scale.reshape(-1), "bias": bias.detach().float()}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float()


@torch.no_grad()
def quantize_vit_params(vit) -> Params:
    """The int8 parameters of a ``VisionTransformer``: per block the fused
    ``qkv`` (rows query, key, value, each ``[H·Dh, D]`` in the JAX ``(H, Dh)``
    order), ``out`` ``[D, H·Dh]``, ``mlp1`` and ``mlp2`` as int8 with f32
    per-row scales; the norms, LayerScale gammas, patch embedding, CLS token
    and position embeddings in f32."""
    blocks = []
    for i in range(vit.depth):
        blk = getattr(vit, f"block{i}")
        a = blk.attn
        qkv_w = torch.cat([a.query.weight, a.key.weight, a.value.weight])
        qkv_b = torch.cat([a.query.bias, a.key.bias, a.value.bias])
        entry = {"heads": a.num_heads, "qkv": _q(qkv_w, qkv_b), "out": _q(a.out.weight, a.out.bias),
                 "mlp1": _q(blk.mlp1.weight, blk.mlp1.bias),
                 "mlp2": _q(blk.mlp2.weight, blk.mlp2.bias),
                 "norm1": (_f32(blk.norm1.weight), _f32(blk.norm1.bias)),
                 "norm2": (_f32(blk.norm2.weight), _f32(blk.norm2.bias))}
        if blk.layer_scale:
            entry["ls1_gamma"], entry["ls2_gamma"] = _f32(blk.ls1_gamma), _f32(blk.ls2_gamma)
        blocks.append(entry)
    pe = vit.patch_embed
    return {"patch_embed": (_f32(pe.weight), _f32(pe.bias)), "patch_size": pe.stride[0],
            "cls_token": _f32(vit.cls_token), "pos_embed": _f32(vit.pos_embed),
            "blocks": blocks, "norm": (_f32(vit.norm.weight), _f32(vit.norm.bias))}


def _layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p[0] + p[1]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """bf16 operand of an f32 product: its products are exact in f32."""
    return t.to(torch.bfloat16).float()


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return int8_dense(x, p["q"], p["s"], p["bias"])


def _attn_int8(x: torch.Tensor, p: Params) -> torch.Tensor:
    b, t, _ = x.shape
    h = p["heads"]
    q, k, v = _dense(x, p["qkv"]).view(b, t, 3, h, -1).permute(2, 0, 3, 1, 4)  # [B, H, T, Dh]
    q = q / math.sqrt(q.shape[-1])          # correctly rounded, as the f32 root
    w = torch.softmax(_bf16(q) @ _bf16(k).transpose(-1, -2), dim=-1)
    o = (_bf16(w) @ _bf16(v)).transpose(1, 2).reshape(b, t, -1)
    return _dense(o, p["out"])


def vit_int8_forward(qparams: Params, images: torch.Tensor) -> torch.Tensor:
    """Normalized images ``[B, H, W, 3]`` -> CLS embeddings ``[B, D]`` f32."""
    w, bias = qparams["patch_embed"]
    ps = qparams["patch_size"]
    x = F.conv2d(_bf16(images.permute(0, 3, 1, 2)), _bf16(w), stride=ps)   # [B, D, gh, gw]
    x = x.flatten(2).transpose(1, 2) + bias                                # tokens row-major
    cls = qparams["cls_token"].expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], 1) + qparams["pos_embed"]
    for blk in qparams["blocks"]:
        h = _attn_int8(_layer_norm(x, blk["norm1"]), blk)
        if "ls1_gamma" in blk:
            h = h * blk["ls1_gamma"]
        x = x + h
        h = F.gelu(_dense(_layer_norm(x, blk["norm2"]), blk["mlp1"]))
        h = _dense(h, blk["mlp2"])
        if "ls2_gamma" in blk:
            h = h * blk["ls2_gamma"]
        x = x + h
    return _layer_norm(x, qparams["norm"])[:, 0].float()
