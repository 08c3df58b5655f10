"""Carry JAX-package weights into the port.

A ``save_model_bundle`` npz holds every flax parameter under its
``/``-joined tree path with a ``p:`` prefix (``p:params/pool/k_proj/kernel``)
and a ``__meta__`` JSON with the ``model_config``. The port's state-dict keys
are the same paths joined by ``.``, with these layout rules:

* ``Dense.kernel [in, out]``            -> ``weight [out, in]``
* ``DenseGeneral.kernel [in, H, D]``     -> ``weight [H·D, in]``, bias ``[H, D]`` -> ``[H·D]``
* ``out_proj.kernel [H, D, out]``        -> ``weight [out, H·D]`` (flax
  ``MultiHeadDotProductAttention`` calls it ``out``)
* ``Conv.kernel [kh, kw, in, out]``      -> ``weight [out, in, kh, kw]``
* LayerNorm ``scale`` / ``bias``         -> ``weight`` / ``bias``
* ``global_query [H, D]``, ``mask_token``, the ViT's ``cls_token``,
  ``pos_embed`` and ``ls*_gamma``, and the MoE's expert parameters
  ``w_in [E, F, H]``, ``b_in [E, H]``, ``w_out [E, H, F]``, ``b_out [E, F]``
  are copied as they are (they are not ``kernel``/``bias`` leaves); the
  MoE's ``router`` is a ``Dense`` and ``moe_norm`` a LayerNorm.

Loading is strict: a missing or unexpected key, or a shape mismatch,
raises ``CheckpointError``. ``params_to_flax`` applies the rules backwards;
which ``Dense`` layers flax holds per head (``DenseGeneral``) it reads off
the modules that own them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.dgdm import DGDMModel
from .models.pooling import GlobalAttentionPool
from .nn.attention import SpatialAttention
from .nn.graph_layers import DynamicGraphLayer
from .utils.exceptions import CheckpointError

KEY_PREFIX = "p:"


def _convert_leaf(module: list, leaf: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 3 and module and module[-1] in ("out_proj", "out"):   # [H, D, out]
            return "weight", a.reshape(-1, a.shape[-1]).T
        if a.ndim == 3:                                            # [in, H, D]
            return "weight", a.reshape(a.shape[0], -1).T
        if a.ndim == 4:                                            # conv
            return "weight", a.transpose(3, 2, 0, 1)
        raise CheckpointError("unexpected kernel rank",
                              {"path": "/".join(module + [leaf]), "shape": list(a.shape)})
    if leaf == "bias":
        return "bias", a.reshape(-1)
    if leaf == "scale":
        return "weight", a
    return leaf, a


def params_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"params/a/b/kernel": array}`` -> ``{"a.b.weight": tensor}``."""
    state = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        name, value = _convert_leaf(parts[:-1], parts[-1], np.asarray(arr))
        state[".".join(parts[:-1] + [name])] = torch.tensor(value, dtype=torch.float32)
    return state


# per module class: its Dense children that flax holds as DenseGeneral with
# per-head outputs ([in, H, D] kernels, [H, D] biases), and those with
# per-head inputs ([H, D, out] kernels)
_PER_HEAD = {DynamicGraphLayer: (("q_proj", "k_proj", "edge_k_proj"), ()),
             SpatialAttention: (("q_proj", "k_proj", "v_proj"), ("out_proj",)),
             GlobalAttentionPool: (("k_proj", "v_proj"), ())}


def _head_layouts(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """Dense module path -> ("out" | "in", heads) for the per-head layers."""
    layouts = {}
    for path, module in model.named_modules():
        outs, ins = _PER_HEAD.get(type(module), ((), ()))
        prefix = f"{path}." if path else ""
        for name in outs:
            if getattr(module, name, None) is not None:
                layouts[prefix + name] = ("out", module.num_heads)
        for name in ins:
            layouts[prefix + name] = ("in", module.num_heads)
    return layouts


def params_to_flax(state: Mapping[str, torch.Tensor], model: nn.Module
                   ) -> Dict[str, np.ndarray]:
    """``{"a.b.weight": tensor}`` -> ``{"params/a/b/kernel": array}``: the
    inverse of :func:`params_from_flax` for ``model``'s state dict. Arrays
    are f32 on the host."""
    layouts = _head_layouts(model)
    flat = {}
    for key, value in state.items():
        a = value.detach().float().cpu().numpy()
        module, _, leaf = key.rpartition(".")
        kind, heads = layouts.get(module, (None, 1))
        if leaf == "weight" and a.ndim == 1:               # LayerNorm
            leaf = "scale"
        elif leaf == "weight" and a.ndim == 4:             # conv
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and kind == "out":           # [in, H, D]
            leaf, a = "kernel", a.T.reshape(a.shape[1], heads, -1)
        elif leaf == "weight" and kind == "in":            # [H, D, out]
            leaf, a = "kernel", a.T.reshape(heads, -1, a.shape[0])
        elif leaf == "weight":
            leaf, a = "kernel", a.T
        elif leaf == "bias" and kind == "out":
            a = a.reshape(heads, -1)
        path = ["params"] + (module.split(".") if module else []) + [leaf]
        flat["/".join(path)] = np.ascontiguousarray(a)
    return flat


def flatten_flax(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax parameter tree -> ``{"params/a/b/kernel": array}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_flax(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def encoder_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VisionTransformer`` / ``SimpleConvEncoder``
    parameter tree (``module.init(...)``, numpy or JAX arrays) -> the state
    dict of the port's module of the same configuration."""
    return params_from_flax(flatten_flax(tree))


def load_state(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Strict load: every model key present, no extra key, same shapes."""
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise CheckpointError(
            "checkpoint/model parameter paths mismatch",
            {"missing": missing[:8], "unexpected": unexpected[:8],
             "n_missing": len(missing), "n_unexpected": len(unexpected)})
    for key, tmpl in want.items():
        if tuple(state[key].shape) != tuple(tmpl.shape):
            raise CheckpointError(
                "checkpoint parameter shape mismatch",
                {"key": key, "ckpt": list(state[key].shape), "model": list(tmpl.shape)})
    model.load_state_dict(state, strict=True)


def load_jax_bundle(path) -> Tuple[DGDMModel, Dict[str, torch.Tensor], dict]:
    """Read a JAX ``save_model_bundle`` npz -> (model on the CPU, state_dict, meta)."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta.get("format") != "named_paths_v2":
            raise CheckpointError("only named-path bundles (format named_paths_v2) "
                                  "can be converted", {"format": meta.get("format")})
        flat = {k[len(KEY_PREFIX):]: data[k] for k in data.files
                if k.startswith(KEY_PREFIX)}
    model = DGDMModel(**meta["model_config"])
    state = params_from_flax(flat)
    load_state(model, state)
    return model.eval(), state, meta
