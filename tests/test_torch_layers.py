"""Layer parity: each ported module against its JAX twin on the CPU.

Parameters are drawn by flax from a seed and carried over with
``convert.params_from_flax``; inputs are seeded numpy. Everything runs in
f32 (JAX under ``default_matmul_precision("float32")``); tolerance 1e-4.
The graph layers take the JAX package's ``gather_impl="pallas"`` (interpret
mode here) where its kernels accept the shape, ``"xla"`` where they do not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.models import decoders as jdec
from dgdm_histopath_tpu.models import encoders as jenc
from dgdm_histopath_tpu.models import pooling as jpool
from dgdm_histopath_tpu.nn import attention as jatt
from dgdm_histopath_tpu.nn import diffusion as jdiff
from dgdm_histopath_tpu.nn import graph_layers as jgl
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models import decoders as tdec
from dgdm_histopath_torch.models import encoders as tenc
from dgdm_histopath_torch.models import pooling as tpool
from dgdm_histopath_torch.nn import attention as tatt
from dgdm_histopath_torch.nn import diffusion as tdiff
from dgdm_histopath_torch.nn import graph_layers as tgl

ATOL = 1e-4
F32 = jnp.float32


def _flat(variables):
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def _carry(torch_module, variables):
    load_state(torch_module, params_from_flax(_flat(variables)))
    return torch_module.eval()


def _init_apply(jmodule, *args, **kw):
    with jax.default_matmul_precision("float32"):
        variables = jax.jit(lambda key, *a: jmodule.init(key, *a, **kw))(
            jax.random.PRNGKey(0), *args)
        return variables, jax.jit(lambda v, *a: jmodule.apply(v, *a, **kw))(variables, *args)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


def _graph(b=2, n=128, k=7, f=24, e=3, n_real=100, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, f).astype(np.float32)
    idx = rs.randint(0, n_real, (b, n, k)).astype(np.int32)
    node_mask = np.zeros((b, n), bool)
    node_mask[:, :n_real] = True
    nbr_mask = (rs.rand(b, n, k) > 0.2) & node_mask[..., None]
    ea = rs.randn(b, n, k, e).astype(np.float32)
    pos = rs.rand(b, n, 2).astype(np.float32)
    return x, idx, nbr_mask, node_mask, ea, pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_graph_convolution_matches_pallas_formulation():
    x, idx, nbr_mask, _, ea, _ = _graph()
    ew = np.random.RandomState(1).rand(*idx.shape).astype(np.float32)
    jm = jgl.GraphConvolution(32, gather_impl="pallas", dtype=F32)
    variables, ref = _init_apply(jm, x, idx, nbr_mask, ea, edge_weight=ew)
    tm = _carry(tgl.GraphConvolution(24, 32, edge_dim=3), variables)
    _close(tm(*_t(x, idx, nbr_mask, ea), edge_weight=torch.from_numpy(ew)), ref)


def test_dynamic_graph_layer_matches_pallas_formulation():
    x, idx, nbr_mask, _, ea, _ = _graph()
    jm = jgl.DynamicGraphLayer(32, num_heads=4, gather_impl="pallas", dtype=F32)
    variables, (ref, ref_attn) = _init_apply(jm, x, idx, nbr_mask, ea,
                                             return_attention=True)
    tm = _carry(tgl.DynamicGraphLayer(24, 32, num_heads=4, edge_dim=3), variables)
    out, attn = tm(*_t(x, idx, nbr_mask, ea), return_attention=True)
    assert "in_proj.weight" in tm.state_dict()
    _close(out, ref)
    _close(attn, ref_attn)


def test_graph_unet_matches_across_pooled_levels():
    """N = 256, so the pooled levels are 128 and 64."""
    x, idx, nbr_mask, node_mask, ea, _ = _graph(n=256, n_real=200, f=32, seed=2)
    jm = jgl.GraphUNet(32, depth=2, num_heads=4, gather_impl="xla", dtype=F32)
    variables, ref = _init_apply(jm, x, idx, nbr_mask, node_mask, ea)
    tm = _carry(tgl.GraphUNet(32, 32, depth=2, num_heads=4, edge_dim=3), variables)
    _close(tm(*_t(x, idx, nbr_mask, node_mask, ea)), ref)


def test_adaptive_pooling_selects_the_same_nodes():
    x, idx, nbr_mask, node_mask, ea, _ = _graph(f=32, seed=3)
    jm = jgl.AdaptiveGraphPooling(0.5, mode="compact", dtype=F32)
    variables, ref = _init_apply(jm, x, node_mask, idx, nbr_mask, ea)
    tm = _carry(tgl.AdaptiveGraphPooling(32, 0.5), variables)
    out = tm(*_t(x, node_mask, idx, nbr_mask, ea))
    np.testing.assert_array_equal(out["sel_idx"].numpy(), np.asarray(ref["sel_idx"]))
    np.testing.assert_array_equal(out["nbr_idx"].numpy(), np.asarray(ref["nbr_idx"]))
    for key in ("x", "edge_attr", "score"):
        _close(out[key], ref[key])


def test_spatial_attention_matches_dense_path():
    x, _, _, node_mask, _, pos = _graph(f=32, seed=4)
    node_mask[1, 10:] = False
    jm = jatt.SpatialAttention(32, 4, dtype=F32)
    variables, (ref, ref_w) = _init_apply(jm, x, pos, node_mask, return_weights=True)
    tm = _carry(tatt.SpatialAttention(32, 4), variables)
    out, w = tm(*_t(x, pos, node_mask), return_weights=True)
    _close(out, ref)
    _close(w, ref_w)


def test_sdpa_zeroes_fully_masked_query_rows():
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 6, 2, 4).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 6), bool)
    mask[1] = False
    ref, ref_w = jatt.scaled_dot_product_attention(q, k, v, key_mask=mask)
    out, w = tatt.scaled_dot_product_attention(*_t(q, k, v), key_mask=torch.from_numpy(mask))
    _close(out, ref, 1e-6)
    _close(w, ref_w, 1e-6)
    assert (w[1] == 0).all() and (out[1] == 0).all()


def test_sinusoidal_position_encoding_matches():
    pos = np.random.RandomState(6).rand(3, 10, 2).astype(np.float32)
    for dim in (16, 18):
        _close(tatt.sinusoidal_position_encoding_2d(torch.from_numpy(pos), dim),
               jatt.sinusoidal_position_encoding_2d(jnp.asarray(pos), dim), 1e-5)


def test_global_attention_pool_matches():
    x, _, _, node_mask, _, _ = _graph(f=32, seed=7)
    jm = jpool.GlobalAttentionPool(32, 4, dtype=F32)
    variables, (ref, ref_w) = _init_apply(jm, x, node_mask, return_weights=True)
    tm = _carry(tpool.GlobalAttentionPool(32, 4), variables)
    out, w = tm(*_t(x, node_mask), return_weights=True)
    _close(out, ref)
    _close(w, ref_w, 1e-6)


@pytest.mark.parametrize("kind", ["mean", "max"])
def test_parameter_free_pools_match(kind):
    x, _, _, node_mask, _, _ = _graph(f=8, seed=8)
    ref = jpool.make_pool(kind, 8).apply({}, x, node_mask)
    _close(tpool.make_pool(kind, 8)(*_t(x, node_mask)), ref, 1e-6)


def test_feature_encoder_matches():
    x = np.random.RandomState(9).randn(2, 10, 24).astype(np.float32)
    jm = jenc.FeatureEncoder(hidden_dims=(32, 32, 16), dtype=F32)
    variables, ref = _init_apply(jm, x)
    tm = _carry(tenc.FeatureEncoder(24, (32, 32, 16)), variables)
    _close(tm(torch.from_numpy(x)), ref)


def test_graph_encoder_matches_with_attention():
    x, idx, nbr_mask, node_mask, ea, _ = _graph(seed=10)
    jm = jenc.GraphEncoder(32, num_layers=2, num_heads=4, edge_dim=3,
                           gather_impl="pallas", dtype=F32)
    variables, ref = _init_apply(jm, x, idx, nbr_mask, node_mask, ea,
                                 return_attention=True)
    tm = _carry(tenc.GraphEncoder(24, 32, 2, 4, edge_dim=3), variables)
    out = tm(*_t(x, idx, nbr_mask, node_mask, ea), return_attention=True)
    _close(out["embeddings"], ref["embeddings"])
    for a, ra in zip(out["attentions"], ref["attentions"]):
        _close(a, ra)


HEADS = {
    "classification": (lambda: jdec.ClassificationHead(3, hidden_dims=(16,), dtype=F32),
                       lambda: tdec.ClassificationHead(12, 3, (16,))),
    "regression": (lambda: jdec.RegressionHead(2, hidden_dims=(16,), dtype=F32,
                                               predict_uncertainty=True),
                   lambda: tdec.RegressionHead(12, 2, (16,), predict_uncertainty=True)),
    "survival_cox": (lambda: jdec.SurvivalHead("cox", hidden_dims=(16,), dtype=F32),
                     lambda: tdec.SurvivalHead(12, "cox", hidden_dims=(16,))),
    "survival_discrete": (lambda: jdec.SurvivalHead("discrete", 5, hidden_dims=(16,),
                                                    dtype=F32),
                          lambda: tdec.SurvivalHead(12, "discrete", 5, (16,))),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_heads_match(head):
    make_j, make_t = HEADS[head]
    x = np.random.RandomState(11).randn(4, 12).astype(np.float32)
    variables, ref = _init_apply(make_j(), x)
    out = _carry(make_t(), variables)(torch.from_numpy(x))
    if isinstance(ref, dict):
        assert set(out) == set(ref)
        for key in ref:
            _close(out[key], ref[key])
    else:
        _close(out, ref)


def test_denoiser_matches():
    rs = np.random.RandomState(12)
    x_t = rs.randn(2, 10, 16).astype(np.float32)
    t = np.array([0, 7], np.int32)
    jm = jdiff.DenoiserMLP(16, dtype=F32)
    variables, ref = _init_apply(jm, x_t, t)
    tm = _carry(tdiff.DenoiserMLP(16), variables)
    _close(tm(*_t(x_t, t)), ref)
