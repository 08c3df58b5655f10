"""Banded message passing, windowed spatial attention and the small
``dgdm-large`` model of the port against the JAX package, f32 on the CPU.

Graphs are built here with numpy: nodes in Morton order, kNN restricted to the
±1-block band of each node (band-exact), or unrestricted kNN (which leaves
out-of-band edges that the banded layers must prune, not mis-address: those
graphs keep their nodes in random order, since with three blocks a Morton
order leaves almost no edge out of band). On the
TPU the band is a [nb, W, 3W] one-hot adjacency; the port masks the
out-of-band slots and runs its gather kernels on absolute indices, so the two
sum the same terms in another order: tolerance 1e-4 for layers, 1e-3 for the
whole model's outputs, 1e-4 of each tensor's largest entry for gradients.

The small Large model keeps what is particular to the preset (16 heads of
width 8 on a 128-wide hidden state, windowed attention and banded message
passing with W = 128, a depth-2 U-Net) at 2 graph layers, 24 input features
and N = 384 (three blocks; pooled levels of 192 and 96 nodes).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.models.presets import PRESETS as J_PRESETS
from dgdm_histopath_tpu.nn import graph_layers as jgl
from dgdm_histopath_tpu.ops import graph as jgraph
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.models.presets import PRESETS, create_model
from dgdm_histopath_torch.nn import graph_layers as tgl
from dgdm_histopath_torch.ops import graph as tgraph
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from test_torch_layers import _carry, _close, _init_apply, _t
from test_torch_model import _flat
from test_torch_training import assert_tree_close, jax_draws, to_torch_graph

F32 = jnp.float32
N, W, K = 384, 128, 6
LARGE_SMALL = dict(node_features=24, hidden_dims=(48, 128), num_diffusion_steps=4,
                   attention_heads=16, graph_layers=2, num_classes=2, dropout=0.0,
                   compute_dtype="float32", spatial_window=W, graph_window=W)
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}


def _morton(pos: np.ndarray) -> np.ndarray:
    q = np.minimum((pos * 65536).astype(np.uint64), 65535)
    code = np.zeros(len(pos), np.uint64)
    for bit in range(16):
        code |= ((q[:, 0] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(2 * bit)
        code |= ((q[:, 1] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(2 * bit + 1)
    return code


def make_graph(seed: int, n_real: int = 350, feat: int = 24, band: bool = True):
    """One padded graph as numpy arrays. ``band``: Morton-ordered nodes and
    the K nearest neighbors inside the ±1-block band. Otherwise nodes in
    random order and the K nearest of all, which puts about two edges in
    nine between block 0 and block 2, out of band."""
    rs = np.random.RandomState(seed)
    pos = rs.rand(n_real, 2).astype(np.float32)
    if band:
        pos = pos[np.argsort(_morton(pos), kind="stable")]
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    if band:
        blk = np.arange(n_real) // W
        d2[np.abs(blk[:, None] - blk[None]) > 1] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :K].astype(np.int32)
    dist = np.sqrt(np.take_along_axis(d2, idx, 1)).astype(np.float32)
    pad = N - n_real
    out = dict(
        x=np.pad(rs.randn(n_real, feat).astype(np.float32), ((0, pad), (0, 0))),
        pos=np.pad(pos, ((0, pad), (0, 0))),
        nbr_idx=np.pad(idx, ((0, pad), (0, 0))),
        nbr_mask=np.pad(np.ones((n_real, K), bool), ((0, pad), (0, 0))),
        edge_attr=np.pad(np.stack([dist, np.exp(-10 * dist), np.zeros_like(dist)], -1),
                         ((0, pad), (0, 0), (0, 0))),
        node_mask=np.arange(N) < n_real)
    return out


def make_batch(band: bool = True, b: int = 2, y=None, feat: int = 24):
    graphs = [make_graph(i, n_real=350 - 20 * i, feat=feat, band=band) for i in range(b)]
    fields = {k: np.stack([g[k] for g in graphs]) for k in graphs[0]}
    jb = jgraph.PaddedGraph(**{k: jnp.asarray(v) for k, v in fields.items()},
                            y=None if y is None else jnp.asarray(y))
    return fields, jb


# ---------------------------------------------------------------------------
# ops/graph.py band helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,window,want", [(384, 128, True), (256, 128, False),
                                           (384, 100, False), (384, None, False),
                                           (512, 64, True), (384, 0, False)])
def test_band_eligible_matches(n, window, want):
    assert tgraph.band_eligible(n, window) == jgraph.band_eligible(n, window) == want


@pytest.mark.parametrize("band", [True, False])
def test_band_helpers_match(band):
    f, _ = make_batch(band)
    idx, mask = f["nbr_idx"], f["nbr_mask"]
    _, ok_ref = jgraph.banded_relative_neighbors(jnp.asarray(idx), jnp.asarray(mask), W)
    ok = tgraph.in_band_mask(*_t(idx, mask), W)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert ok.dtype == torch.bool
    frac = tgraph.in_band_fraction(*_t(idx, mask), W)
    assert frac == jgraph.in_band_fraction(idx, mask, W)
    assert (frac == 1.0) == band and (band or frac < 0.99)
    assert torch.equal(tgraph.band_prune(*_t(idx, mask), W), ok)
    assert torch.equal(tgraph.band_prune(*_t(idx, mask), None), torch.from_numpy(mask))
    assert torch.equal(tgraph.band_prune(*_t(idx, mask), 256), torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# banded layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band", [True, False], ids=["band_exact", "out_of_band"])
def test_banded_graph_convolution_matches_jax(band):
    f, _ = make_batch(band)
    ew = np.random.RandomState(1).rand(*f["nbr_idx"].shape).astype(np.float32)
    args = (f["x"], f["nbr_idx"], f["nbr_mask"], f["edge_attr"])
    jm = jgl.GraphConvolution(32, band_window=W, dtype=F32)
    variables, ref = _init_apply(jm, *args, edge_weight=ew)
    tm = _carry(tgl.GraphConvolution(24, 32, edge_dim=3, band_window=W), variables)
    _close(tm(*_t(*args), edge_weight=torch.from_numpy(ew)), ref)


@pytest.mark.parametrize("band", [True, False], ids=["band_exact", "out_of_band"])
def test_banded_dynamic_graph_layer_matches_jax(band):
    f, _ = make_batch(band)
    args = (f["x"], f["nbr_idx"], f["nbr_mask"] & f["node_mask"][..., None], f["edge_attr"])
    jm = jgl.DynamicGraphLayer(32, num_heads=4, band_window=W, dtype=F32)
    variables, (ref, ref_attn) = _init_apply(jm, *args, return_attention=True)
    tm = _carry(tgl.DynamicGraphLayer(24, 32, num_heads=4, edge_dim=3, band_window=W),
                variables)
    out, attn = tm(*_t(*args), return_attention=True)
    _close(out, ref)
    _close(attn, ref_attn)
    # the band prunes, it does not mis-address: the same layer without a band
    # on the pruned mask gives the same numbers, and out-of-band edges matter
    plain = _carry(tgl.DynamicGraphLayer(24, 32, num_heads=4, edge_dim=3), variables)
    pruned = tgraph.band_prune(*_t(args[1], args[2]), W)
    assert torch.equal(plain(*_t(args[0], args[1]), pruned, torch.from_numpy(args[3])), out)
    differs = not torch.allclose(plain(*_t(*args)), out, atol=1e-4)
    assert differs == (not band)


@pytest.mark.parametrize("band", [True, False], ids=["band_exact", "out_of_band"])
def test_banded_graph_unet_matches_jax(band):
    """Only the full-N levels (down0, up0) are banded."""
    f, _ = make_batch(band, feat=32)
    args = (f["x"], f["nbr_idx"], f["nbr_mask"], f["node_mask"], f["edge_attr"])
    jm = jgl.GraphUNet(32, depth=2, num_heads=4, band_window=W, dtype=F32)
    variables, ref = _init_apply(jm, *args)
    tm = _carry(tgl.GraphUNet(32, 32, depth=2, num_heads=4, edge_dim=3, band_window=W),
                variables)
    _close(tm(*_t(*args)), ref)
    assert [getattr(tm, name).band_window for name in
            ("down0", "down1", "bottleneck", "up0", "up1")] == [W, None, None, W, None]


# ---------------------------------------------------------------------------
# dgdm-large at a small size
# ---------------------------------------------------------------------------

def test_large_preset_is_the_reference_preset_and_builds():
    assert PRESETS["dgdm-large"] == J_PRESETS["dgdm-large"]
    model = create_model("dgdm-large", num_classes=2, device="cpu", graph_layers=1)
    assert model.spatial_attention.window_size == 128
    assert model.spatial_attention.num_heads == 16 and model.hidden_dims[-1] == 128
    assert model.graph_encoder.layer0.band_window == 128
    assert model.graph_unet.up0.band_window == 128 and model.graph_unet.up1.band_window is None


@pytest.fixture(scope="module")
def large_small():
    """(JAX model, its parameters, the port's model) on the band-exact batch."""
    fields, jb = make_batch(True, y=np.array([1, 0], np.int32))
    jm = JaxDGDM(**LARGE_SMALL)
    with jax.default_matmul_precision("float32"):
        params = jax.jit(lambda g: jm.init(RNGS, g, mode="pretrain", deterministic=True))(jb)
    tm = DGDMModel(**LARGE_SMALL)
    load_state(tm, params_from_flax(_flat(params)))      # strict
    return jm, params, tm.eval(), jb


@pytest.mark.parametrize("return_attention", [False, True], ids=["windowed", "with_weights"])
def test_large_small_inference_matches_jax(large_small, return_attention):
    """Without the weights the spatial attention is windowed; asking for them
    (as the predictor does) forces its dense route, in both packages."""
    jm, params, tm, jb = large_small
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(lambda p, g: jm.apply(p, g, mode="inference", deterministic=True,
                                            return_attention=return_attention))(params, jb)
    with torch.inference_mode():
        out = tm(to_torch_graph(jb), mode="inference", return_attention=return_attention)
    assert tm.spatial_attention.route(N, True, return_attention) == (
        "dense" if return_attention else "window")
    for key in ("classification_logits", "graph_embedding", "node_embeddings"):
        _close(out[key], ref[key], 1e-3)
    if return_attention:
        _close(out["attention_weights"], ref["attention_weights"], 1e-3)
        _close(out["spatial_attention"], ref["spatial_attention"], 1e-3)
        for a, b in zip(out["edge_attentions"], ref["edge_attentions"]):
            _close(a, b, 1e-3)


def test_large_small_predictor_loads_a_jax_bundle_strictly(large_small, tmp_path):
    from dgdm_histopath_tpu.training.checkpoint import save_model_bundle
    jm, params, tm, jb = large_small
    path = tmp_path / "large_small.npz"
    save_model_bundle(str(path), params, LARGE_SMALL)
    predictor = DGDMPredictor(model_path=str(path), device="cpu")
    assert predictor.model.graph_window == W and predictor.model.spatial_window == W
    tb = to_torch_graph(jb)
    graphs = [tgraph.PaddedGraph(**{f: getattr(tb, f)[i] for f in
                                    ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr",
                                     "node_mask")}) for i in range(2)]
    results = predictor.predict_batch(graphs)
    with jax.default_matmul_precision("float32"):
        ref = jm.apply(params, jb, mode="inference", deterministic=True,
                       return_attention=True)
    probs = np.asarray(jax.nn.softmax(ref["classification_logits"].astype(F32), -1))
    for i, r in enumerate(results):
        np.testing.assert_allclose(r["probabilities"], probs[i], atol=1e-3)


@pytest.mark.parametrize("phase", ["pretrain", "finetune"])
def test_large_small_training_losses_and_gradients_match_jax(large_small, phase):
    """Loss, metrics and every parameter's gradient of one step's objective
    (windowed attention and banded message passing on the training path),
    the JAX side's draws injected."""
    jm, params, tm, jb = large_small
    batch = jb if phase == "finetune" else jb.replace(y=None)
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(), use_mesh=False)
    loss_fn = jt._pretrain_losses if phase == "pretrain" else jt._finetune_losses
    with jax.default_matmul_precision("float32"):
        draws = jax_draws(jm, params, batch, RNGS) if phase == "pretrain" else None
        (loss_ref, metrics_ref), grads_ref = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, batch, RNGS), has_aux=True))(params)
    tt = DGDMTrainer(tm, TrainerConfig(), device="cpu")
    tt.init_state(0, example_batch=to_torch_graph(batch))
    tm.zero_grad()
    fn = tt._pretrain_losses if phase == "pretrain" else tt._finetune_losses
    loss, metrics = fn(to_torch_graph(batch), draws)
    assert set(metrics) == set(metrics_ref)
    for key, ref in metrics_ref.items():
        np.testing.assert_allclose(float(metrics[key].detach()), float(ref), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    loss.backward()
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in tm.named_parameters()}
    assert_tree_close(got, params_from_flax(_flat(grads_ref)), 1e-4, "gradient")


def test_band_guard_raises_or_warns_as_the_reference(large_small, caplog):
    jm, _, tm, jb = large_small
    _, loose = make_batch(band=False)
    tloose, texact = to_torch_graph(loose), to_torch_graph(jb)
    with pytest.raises(ValueError, match="in-band") as ref_err:
        jtr.DGDMTrainer(jm, jtr.TrainerConfig(), use_mesh=False).init_state(
            jax.random.PRNGKey(0), loose)
    with pytest.raises(ValueError, match="in-band") as err:
        DGDMTrainer(tm, TrainerConfig(), device="cpu").init_state(0, example_batch=tloose)
    # the same measured fraction in both messages
    assert str(err.value).split("%")[0] == str(ref_err.value).split("%")[0]
    assert "allow_out_of_band_graphs=True" in str(err.value)
    with caplog.at_level(logging.WARNING, logger="dgdm_histopath_torch.training"):
        trainer = DGDMTrainer(tm, TrainerConfig(allow_out_of_band_graphs=True), device="cpu")
        trainer.init_state(0, example_batch=tloose)
    assert "Proceeding anyway" in caplog.text and trainer.optimizer is not None
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dgdm_histopath_torch.training"):
        DGDMTrainer(tm, TrainerConfig(), device="cpu").init_state(0, example_batch=texact)
        unbanded = DGDMModel(**{**LARGE_SMALL, "graph_window": None})
        DGDMTrainer(unbanded, TrainerConfig(), device="cpu").init_state(
            0, example_batch=tloose)
    assert caplog.text == ""
