"""The MoE tier of the port against the JAX package, f32 on the CPU.

``MoEFFN`` against JAX ``MoEFFN`` at top-1 and top-2, with capacity drops,
a padded graph and a filler graph (all padding): outputs within 1e-5, the
aux loss within 1e-6, each token's first expert and the dropped tokens
equal (JAX's first choice read off its router's captured logits, its
dropped tokens off their zero output rows). The ``DGDMModel(moe_experts=4)``
forward, a bundle round trip through both packages' loaders, and 3 pretrain
+ 2 finetune trainer steps against the JAX trainer (metrics 1e-4,
parameters 1e-5, the shift-invariant key biases excepted as in
tests/test_torch_training.py; the router bias is held to 1e-5 like every
other parameter: the softmax over experts cancels only a shift of all its
entries together, and each entry has a gradient of its own). Last,
``configs/dgdm_base_moe.yaml`` builds its trainer and takes a step.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.evaluation.predictor import DGDMPredictor as JaxPredictor
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.nn.moe import MoEFFN as JaxMoE
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.training import checkpoint as jckpt
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch import DGDMPredictor
from dgdm_histopath_torch.convert import load_jax_bundle, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.nn.moe import MoEFFN, routing_group
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig, save_model_bundle
from dgdm_histopath_torch.utils.config import load_config
from dgdm_histopath_torch.utils.exceptions import ConfigurationError
from test_torch_model import _flat
from test_torch_training import (
    SHIFT_INVARIANT_BIASES,
    jax_draws,
    make_batch,
    to_torch_graph,
    torch_model,
)

MOE_KW = dict(moe_experts=4, moe_top_k=1, moe_capacity=1.5)
B, N, F, H, E = 3, 64, 16, 24, 4


def moe_inputs():
    """3 sequences of 64 tokens: one whole, one padded after 40, one filler."""
    rs = np.random.RandomState(0)
    x = rs.randn(B, N, F).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 40:] = False
    mask[2] = False
    return x, mask


@pytest.mark.parametrize("top_k,cf,group", [(1, 1.5, 64), (2, 0.5, 64), (1, 0.5, 128),
                                            (2, 1.5, 1024)])
def test_moe_ffn_matches_jax(top_k, cf, group):
    x, mask = moe_inputs()
    jm = JaxMoE(features=F, hidden_dim=H, num_experts=E, top_k=top_k, capacity_factor=cf,
                group_size=group, dtype=jnp.float32)
    with jax.default_matmul_precision("float32"):
        params = jm.init(jax.random.PRNGKey(top_k), jnp.asarray(x), jnp.asarray(mask))
        (out, aux), state = jm.apply(params, jnp.asarray(x), jnp.asarray(mask),
                                     capture_intermediates=True)
    logits = np.asarray(state["intermediates"]["router"]["__call__"][0])
    tm = MoEFFN(F, H, E, top_k, cf, group, dtype=torch.float32)
    tm.load_state_dict(params_from_flax(_flat(params)))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got, got_aux = tm(xt, mt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got_aux.detach()), float(aux), atol=1e-6, rtol=0)

    r = tm.route(xt, mt)
    grp = routing_group(B * N, N, group)
    assert r["dispatch"].shape == (B * N // grp, grp, E, tm.capacity(grp))
    flat_mask = mask.reshape(-1)
    first = r["first_choice"].reshape(-1, E)
    assert np.array_equal(first.argmax(-1).numpy()[flat_mask],
                          logits.reshape(-1, E).argmax(-1)[flat_mask])
    assert not first[~torch.from_numpy(flat_mask)].any()          # padding claims nothing
    dropped = (r["kept"].reshape(-1, E).sum(-1) == 0).numpy() & flat_mask
    jax_zero = (np.abs(np.asarray(out)).reshape(-1, F).max(-1) == 0) & flat_mask
    assert np.array_equal(dropped, jax_zero)
    if cf < 1.0:
        assert dropped.any()                                     # the case drops tokens
    assert not got.detach()[~mt].any()
    # each expert takes at most its capacity per group
    assert float(r["kept"].sum(1).max()) <= tm.capacity(grp)


def test_moe_capacity_group_and_options():
    """The reference's float ceiling division, clamped to [1, G]: 384 at
    DGDM-Base (cf 1.5, G 1024, top-1, 4 experts); groups fall back to the
    sequence length when they do not divide the tokens."""
    assert MoEFFN(8, 8, 4, 1, 1.5).capacity(1024) == 384
    assert MoEFFN(8, 8, 4, 2, 1.5).capacity(1024) == 768
    assert MoEFFN(8, 8, 4, 1, 0.001).capacity(64) == 1
    assert MoEFFN(8, 8, 2, 2, 4.0).capacity(64) == 64
    assert routing_group(32 * 1024, 1024, 1024) == 1024
    assert routing_group(3 * 64, 64, 1024) == 192
    assert routing_group(3 * 384, 384, 1024) == 384
    with pytest.raises(ValueError, match="top_k"):
        MoEFFN(8, 8, 4, top_k=3)
    with pytest.raises(ConfigurationError, match="moe_top_k"):
        DGDMModel(node_features=8, hidden_dims=(8,), attention_heads=2, moe_experts=2,
                  moe_top_k=3)
    model = DGDMModel(node_features=8, hidden_dims=(16, 8), attention_heads=2, **MOE_KW)
    assert model.moe_ffn.hidden_dim == 16 and model.moe_ffn.w_in.shape == (4, 8, 16)
    init_parameters(model, torch.Generator().manual_seed(0))
    std = float(model.moe_ffn.w_in.detach().std())
    assert 0.5 / np.sqrt(4 * 8) < std < 1.5 / np.sqrt(4 * 8)     # fan-in E·F, as flax
    assert not model.moe_ffn.b_in.any()


def test_moe_dropout_draws_from_the_generator():
    x, mask = moe_inputs()
    tm = MoEFFN(F, H, E, 1, 1.5, 64, dropout=0.5, dtype=torch.float32)
    init_parameters(tm, torch.Generator().manual_seed(0))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)

    def run(seed, deterministic=False):
        return tm(xt, mt, deterministic=deterministic,
                  generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(run(1, True), run(2, True)) and not torch.equal(run(1), run(1, True))


@pytest.fixture(scope="module")
def moe_pair():
    kw = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3,
              attention_heads=4, graph_layers=2, num_classes=2, compute_dtype="float32",
              dropout=0.0, regression_targets=0, survival_mode=None, **MOE_KW)
    batch = make_batch()
    jm = JaxDGDM(**kw, gather_impl="xla")
    with jax.default_matmul_precision("float32"):
        params = jm.init({"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
                          "masking": jax.random.PRNGKey(2)}, batch, mode="pretrain",
                         deterministic=True)
        ref = jm.apply(params, batch)
    tm = DGDMModel(**kw)
    tm.load_state_dict(params_from_flax(_flat(params)))
    return {"kw": kw, "jm": jm, "params": params, "tm": tm, "batch": batch, "ref": ref}


def test_dgdm_moe_forward_matches_jax(moe_pair):
    tm, ref = moe_pair["tm"], moe_pair["ref"]
    with torch.no_grad():
        out = tm(to_torch_graph(moe_pair["batch"]))
    assert {"moe_ffn", "moe_norm"} <= {n for n, _ in tm.named_children()}
    np.testing.assert_allclose(out["classification_logits"].numpy(),
                               np.asarray(ref["classification_logits"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(out["moe_aux_loss"]), float(ref["moe_aux_loss"]),
                               atol=1e-6, rtol=0)
    assert out["moe_aux_loss"].dtype == torch.float32


def test_moe_bundle_round_trip_and_predictor_keys(moe_pair, tmp_path):
    """A JAX bundle with ``moe_experts`` loads into an MoE model; the port's
    bundle of it loads into the JAX package with the same arrays. The
    predictor returns the JAX predictor's keys (no aux loss there either)."""
    cfg = {k: v for k, v in moe_pair["kw"].items()}
    cfg["hidden_dims"] = list(cfg["hidden_dims"])
    jckpt.save_model_bundle(tmp_path / "jax.npz", moe_pair["params"], cfg)
    model, state, meta = load_jax_bundle(tmp_path / "jax.npz")
    assert model.moe_experts == 4 and meta["model_config"]["moe_experts"] == 4
    assert model.moe_ffn.w_in.shape == (4, 16, 32)
    assert "moe_ffn.w_in" in state and "moe_ffn.router.weight" in state
    np.testing.assert_array_equal(state["moe_ffn.b_out"].numpy(),
                                  np.asarray(moe_pair["params"]["params"]["moe_ffn"]["b_out"]))
    save_model_bundle(tmp_path / "port.npz", model, cfg)
    back = jckpt.load_model_bundle(tmp_path / "port.npz", moe_pair["params"])
    for key, arr in _flat(moe_pair["params"]).items():
        np.testing.assert_array_equal(_flat(back)[key], arr, err_msg=key)
    meta = json.loads(str(np.load(tmp_path / "port.npz")["__meta__"]))
    assert meta["model_config"]["moe_experts"] == 4

    graphs = [to_torch_graph(jax.tree_util.tree_map(lambda a: a[i], moe_pair["batch"]))
              for i in range(2)]
    ours = DGDMPredictor(model=model, device="cpu").predict_batch(graphs)
    theirs = JaxPredictor(model=moe_pair["jm"], params=moe_pair["params"]).predict_batch(
        [jax.tree_util.tree_map(lambda a: a[i], moe_pair["batch"]) for i in range(2)])
    assert [set(r) for r in ours] == [set(r) for r in theirs]
    assert all("moe_aux_loss" not in r for r in ours)


def test_moe_trainer_steps_match_the_jax_trainer(moe_pair):
    """3 pretrain steps then 2 finetune steps with labels, as
    test_trainer_steps_match_the_jax_trainer: ``moe_aux_loss`` is among the
    metrics of both phases and weighs into the loss."""
    kw, y = moe_pair["kw"], np.array([1, 0, 1], np.int32)
    cfg = dict(learning_rate=1e-3, warmup_steps=2, steps_per_epoch=3, pretrain_epochs=1,
               max_epochs=2)
    batch = make_batch(y)
    jm = moe_pair["jm"]
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**cfg), use_mesh=False)
    with jax.default_matmul_precision("float32"):
        state = jt.init_state(jax.random.PRNGKey(11), batch)
        params0 = jax.device_get(state.params)
        state_rng = jnp.asarray(np.array(state.rng))
        tm = torch_model(params0, **kw)
        tt = DGDMTrainer(tm, TrainerConfig(**cfg), device="cpu")
        tt.init_state(seed=0)
        tbatch = to_torch_graph(batch)
        for step, epoch in enumerate([0, 0, 0, 1, 1]):
            rng = jax.random.fold_in(state_rng, step)
            rngs = {"diffusion": jax.random.fold_in(rng, 0),
                    "masking": jax.random.fold_in(rng, 1), "dropout": jax.random.fold_in(rng, 2)}
            draws = jax_draws(jm, params0, batch, rngs)
            ref = jt.training_step(batch, epoch)
            got = tt.training_step(tbatch, epoch, draws=draws)
            assert set(got) == set(ref) and "moe_aux_loss" in got, (step, set(got) ^ set(ref))
            for key in ref:
                np.testing.assert_allclose(got[key], ref[key], atol=1e-4, rtol=1e-4,
                                           err_msg=f"step {step} {key}")
    ref_params = params_from_flax(_flat(jax.device_get(jt.state.params)))
    got_params = dict(tm.named_parameters())
    assert set(got_params) == set(ref_params)
    lr_sum = sum(tt.lr_schedule(s) for s in range(5))
    for key, ref in ref_params.items():
        atol = lr_sum if key.endswith(SHIFT_INVARIANT_BIASES) else 1e-5
        np.testing.assert_allclose(got_params[key].detach().numpy(), ref.numpy(), atol=atol,
                                   rtol=0, err_msg=key)
    w_in0 = torch.from_numpy(np.array(params0["params"]["moe_ffn"]["w_in"]))
    assert float((got_params["moe_ffn.w_in"].detach() - w_in0).abs().max()) > 1e-4


def test_the_moe_config_builds_and_trains():
    """``configs/dgdm_base_moe.yaml`` at its full width: DGDM-Base with 4
    experts, top-1, capacity 1.5, hidden 2 x 128; one pretrain step on two
    small graphs of its feature width."""
    cfg = load_config(Path(__file__).resolve().parents[1] / "configs" / "dgdm_base_moe.yaml")
    trainer = DGDMTrainer.from_config(cfg, device="cpu")
    moe = trainer.model.moe_ffn
    assert (moe.num_experts, moe.top_k, moe.capacity_factor, moe.hidden_dim) == (4, 1, 1.5, 256)
    assert trainer.model.hidden_dims == [512, 256, 128] and trainer._dp is None
    trainer.init_state(0)
    batch = to_torch_graph(j_batch([make_synthetic_graph(n_nodes=64, n_real=50, feat_dim=768,
                                                     seed=i) for i in range(2)]))
    metrics = trainer.training_step(batch, 0)
    assert metrics["moe_aux_loss"] > 0 and np.isfinite(list(metrics.values())).all()
