"""Parity of the port's model extras with the JAX package's, on the CPU:
``MultiHeadAttention`` (key mask, bias, returned weights),
``CrossModalAttention``, ``PositionalEncoder``, ``HierarchicalEncoder`` in
both input forms, ``MultiTaskHead`` with ``combined_loss``, ``list_presets``,
the masked neighbour sum and mean, and the models package's exports.

Each JAX module is initialised once (module fixtures), its parameters load
strictly into the port's module through ``convert.params_from_flax``, and the
same seeded numpy inputs go through both in f32 (the JAX side at
``default_matmul_precision("float32")``): outputs within 1e-5 (1e-4 through
the graph encoders' stacked layers; the test models' tolerance of 1e-3 for
the whole DGDM forward is looser still).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu import models as jmodels
from dgdm_histopath_tpu.models import HierarchicalEncoder as JHier
from dgdm_histopath_tpu.models import MultiTaskHead as JMultiTask
from dgdm_histopath_tpu.models import PositionalEncoder as JPos
from dgdm_histopath_tpu.nn.attention import CrossModalAttention as JCross
from dgdm_histopath_tpu.nn.attention import MultiHeadAttention as JMHA
from dgdm_histopath_tpu.ops import graph as jg
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_torch import models as tmodels
from dgdm_histopath_torch.convert import load_state, params_from_flax, params_to_flax
from dgdm_histopath_torch.models import HierarchicalEncoder, MultiTaskHead, PositionalEncoder
from dgdm_histopath_torch.nn.attention import CrossModalAttention, MultiHeadAttention
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.ops import graph as tg
from test_torch_model import _flat

F32 = dict(dtype=jnp.float32)
TASKS = {"subtype": {"type": "classification", "num_classes": 4},
         "grade": {"type": "regression", "num_targets": 1}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol=1e-5):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _load(module, params):
    load_state(module, params_from_flax(_flat(params)))
    return module.eval()


def _jax(fn):
    with jax.default_matmul_precision("float32"):
        return fn()


def small_batch(feat_dim=32, n_nodes=32, n_real=24, b=2):
    return j_batch([make_synthetic_graph(seed=i, n_nodes=n_nodes, n_real=n_real,
                                         feat_dim=feat_dim) for i in range(b)])


@pytest.fixture(scope="module")
def mha():
    """(JAX module, params, port module, inputs): 16 wide, 4 heads, a key
    width of 24, a key mask and a per-head bias."""
    rs = np.random.RandomState(0)
    q = rs.randn(2, 10, 16).astype(np.float32)
    kv = rs.randn(2, 7, 24).astype(np.float32)
    mask = np.array([[True] * 5 + [False] * 2, [True] * 7])
    bias = rs.randn(2, 4, 10, 7).astype(np.float32)
    jm = JMHA(embed_dim=16, num_heads=4, **F32)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), q, kv, kv, key_mask=mask))
    tm = _load(MultiHeadAttention(16, 4, kv_features=24), params)
    return jm, params, tm, dict(q=q, kv=kv, mask=mask, bias=bias)


@pytest.mark.parametrize("case", ["self", "cross_masked_biased"])
def test_multi_head_attention_matches_jax(mha, case):
    jm, params, tm, a = mha
    if case == "self":
        # self-attention needs a query as wide as the keys: the same module's
        # parameters over a 24-wide query
        q = np.random.RandomState(1).randn(2, 7, 24).astype(np.float32)
        jq = JMHA(embed_dim=16, num_heads=4, **F32)
        p = _jax(lambda: jq.init(jax.random.PRNGKey(3), q))
        ref = _jax(lambda: jq.apply(p, q))
        out = _load(MultiHeadAttention(16, 4, q_features=24, kv_features=24), p)(_t(q))
        _close(out, ref)
        return
    ref, ref_w = _jax(lambda: jm.apply(params, a["q"], a["kv"], a["kv"], key_mask=a["mask"],
                                       bias=a["bias"], return_weights=True))
    out, w = tm(_t(a["q"]), _t(a["kv"]), _t(a["kv"]), key_mask=_t(a["mask"]),
                bias=_t(a["bias"]), return_weights=True)
    _close(out, ref)
    _close(w, ref_w)
    assert float(w.detach()[0, :, :, 5:].abs().max()) == 0.0     # no mass on masked keys


def test_multi_head_attention_flax_layout_round_trip(mha):
    """params_to_flax gives back JAX's tree: per-head [in, H, D] q/k/v
    kernels and [H, D] biases, the [H, D, out] out_proj kernel."""
    _, params, tm, _ = mha
    back = params_to_flax(tm.state_dict(), tm)
    want = _flat(params)
    assert set(back) == set(want)
    for key, value in want.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value)


@pytest.fixture(scope="module")
def cross_modal():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 16).astype(np.float32)
    ctx = rs.randn(2, 5, 16).astype(np.float32)
    ctx_mask = np.array([[True] * 5, [True] * 2 + [False] * 3])
    x_mask = np.array([[True, True, False], [True] * 3])
    jm = JCross(embed_dim=16, num_heads=4, **F32)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(1), x, ctx, context_mask=ctx_mask,
                                  x_mask=x_mask))
    return jm, params, _load(CrossModalAttention(16, 4), params), (x, ctx, ctx_mask, x_mask)


@pytest.mark.parametrize("masks", [False, True])
def test_cross_modal_attention_matches_jax(cross_modal, masks):
    """Both masks, or none; the FFN's tanh-GELU included."""
    jm, params, tm, (x, ctx, ctx_mask, x_mask) = cross_modal
    kw = dict(context_mask=ctx_mask, x_mask=x_mask) if masks else {}
    ref = _jax(lambda: jm.apply(params, x, ctx, **kw))
    out = tm(_t(x), _t(ctx), **{k: _t(v) for k, v in kw.items()})
    _close(out, ref)
    if masks:
        assert float(out.detach()[0, 2].abs().max()) == 0.0


def test_positional_encoder_matches_jax():
    pos = np.random.RandomState(3).rand(2, 20, 2).astype(np.float32)
    jm = JPos(embed_dim=24, **F32)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), pos))
    ref = _jax(lambda: jm.apply(params, pos))
    _close(_load(PositionalEncoder(24), params)(_t(pos)), ref)


@pytest.fixture(scope="module")
def hier_single():
    """HierarchicalEncoder(hidden 16, 3 levels, 4 heads) on one graph batch
    (levels derived in the model), the sizes of tests/test_model.py."""
    g = small_batch(feat_dim=32)
    jm = JHier(hidden_dim=16, num_levels=3, num_heads=4, **F32)
    args = (g.x, g.nbr_idx, g.nbr_mask, g.node_mask, g.edge_attr)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), *args))
    ref = _jax(lambda: jm.apply(params, *args))
    tm = _load(HierarchicalEncoder(32, 16, num_levels=3, num_heads=4), params)
    return g, params, ref, tm


def test_hierarchical_encoder_single_graph_matches_jax(hier_single):
    g, _, ref, tm = hier_single
    args = [_t(getattr(g, f)) for f in ("x", "nbr_idx", "nbr_mask", "node_mask", "edge_attr")]
    out = tm(*args)
    assert out.shape == (2, 16)
    _close(out, ref, 1e-4)
    # padding invariance: garbage in the padded rows leaks nowhere
    args[0] = args[0] + 1e3 * (~args[3])[..., None].float()
    _close(tm(*args), ref, 1e-4)


def test_hierarchical_encoder_levels_match_compaction(hier_single):
    """The derived levels: each keeps round(N / 2) nodes of highest degree,
    equal to the JAX compaction slot for slot."""
    g, _, _, tm = hier_single
    levels = tm.levels(_t(g.x), _t(g.nbr_idx), _t(g.nbr_mask), _t(g.node_mask),
                       _t(g.edge_attr))
    assert [lv["x"].shape[1] for lv in levels] == [32, 16, 8]
    deg = jnp.sum(g.nbr_mask, axis=-1).astype(jnp.float32)
    c = jg.compact_top_k_nodes(g.x, g.nbr_idx, g.nbr_mask, g.node_mask, deg, 16,
                               edge_attr=g.edge_attr)
    for key in ("nbr_idx", "nbr_mask", "node_mask"):
        np.testing.assert_array_equal(levels[1][key].numpy(), np.asarray(c[key]))
    np.testing.assert_array_equal(levels[1]["x"].numpy(), np.asarray(c["x"]))


def test_hierarchical_encoder_per_level_graphs_match_jax():
    levels = [small_batch(feat_dim=32, n_nodes=32, n_real=24),
              small_batch(feat_dim=32, n_nodes=16, n_real=12)]
    fields = ("x", "nbr_idx", "nbr_mask", "node_mask", "edge_attr")
    args = [[getattr(g, f) for g in levels] for f in fields]
    jm = JHier(hidden_dim=16, num_levels=2, num_heads=4, **F32)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), *args))
    ref = _jax(lambda: jm.apply(params, *args))
    tm = _load(HierarchicalEncoder(32, 16, num_levels=2, num_heads=4), params)
    _close(tm(*[[_t(a) for a in arg] for arg in args]), ref, 1e-4)


def test_hierarchical_encoder_wrong_level_count_raises(hier_single):
    g, _, _, tm = hier_single
    one = [[_t(getattr(g, f))] for f in ("x", "nbr_idx", "nbr_mask", "node_mask",
                                         "edge_attr")]
    with pytest.raises(ValueError, match="per-level graphs"):
        tm(*one)
    with pytest.raises(ValueError, match="per-level graphs"):
        JHier(hidden_dim=16, num_levels=3, num_heads=4, **F32).init(
            jax.random.PRNGKey(0), *[[np.asarray(a[0])] for a in one])


@pytest.fixture(scope="module")
def multitask():
    x = np.random.RandomState(4).randn(4, 16).astype(np.float32)
    jm = JMultiTask(task_configs=TASKS, **F32)
    params = _jax(lambda: jm.init(jax.random.PRNGKey(0), x))
    params = jax.tree_util.tree_map(lambda a: a, params)
    params["params"]["log_vars"] = jnp.asarray([0.3, -0.2], jnp.float32)
    tm = _load(MultiTaskHead(16, TASKS), params)
    return jm, params, tm, x


def test_multitask_head_matches_jax(multitask):
    jm, params, tm, x = multitask
    ref = _jax(lambda: jm.apply(params, x))
    out = tm(_t(x))
    assert set(out) == set(ref) == set(TASKS)
    _close(out["subtype"], ref["subtype"])
    _close(out["grade"]["mean"], ref["grade"]["mean"])


def test_multitask_combined_loss_matches_jax(multitask):
    jm, params, tm, _ = multitask
    losses = {"subtype": 1.25, "grade": 0.5}
    ref = jm.apply(params, {k: jnp.asarray(v) for k, v in losses.items()},
                   method=JMultiTask.combined_loss)
    out = tm.combined_loss({k: torch.tensor(v) for k, v in losses.items()})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-6)


def test_list_presets_and_exports_match_jax():
    assert tmodels.list_presets() == jmodels.list_presets()
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert getattr(tmodels, name) is not None


@pytest.mark.parametrize("which", ["sum", "mean"])
def test_masked_neighbor_sum_and_mean_match_jax(which):
    rs = np.random.RandomState(5)
    msgs = rs.randn(2, 12, 5, 8).astype(np.float32)
    mask = rs.rand(2, 12, 5) > 0.4
    mask[0, 0] = False                           # a row without any valid slot
    ref = getattr(jg, f"masked_neighbor_{which}")(jnp.asarray(msgs), jnp.asarray(mask))
    out = getattr(tg, f"masked_neighbor_{which}")(_t(msgs), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    assert float(out[0, 0].abs().max()) == 0.0


def test_new_parameters_draw_like_flax():
    """init_parameters: MultiTaskHead's log_vars zeros, the per-head
    projections lecun-normal over their input width."""
    head = init_parameters(MultiTaskHead(16, TASKS), torch.Generator().manual_seed(0))
    assert torch.equal(head.log_vars, torch.zeros(2))
    mha_t = init_parameters(MultiHeadAttention(64, 4, kv_features=96),
                            torch.Generator().manual_seed(0))
    std = float(mha_t.k_proj.weight.std())
    assert abs(std - (1 / 96) ** 0.5) < 0.15 * (1 / 96) ** 0.5
