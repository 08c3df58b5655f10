"""The training slice of the port against the JAX package, f32 on the CPU:
``pretrain_step`` outputs, loss and every parameter gradient against
``jax.grad``; the learning-rate schedule against optax; whole optimizer steps
of the port's ``DGDMTrainer`` against the JAX ``DGDMTrainer(use_mesh=False)``;
dropout; the options that are not ported; ``fit``.

The two frameworks cannot share random numbers, so every draw of the JAX
side is read back and injected into the port: the entity mask from
``masked_nodes``, the diffusion ``(noise, t)`` from flax's captured
intermediates of ``DiffusionLayer.__call__``, and the contrastive scores
from ``jax.random.uniform(fold_in(rngs["masking"], 17), (B, N))``. The draws
depend on the rngs and shapes only, so for a trainer step the test rebuilds
the step's rngs as the JAX step does and reads the draws with one ``apply``.

The small model is the one of tests/test_torch_model.py (dropout 0, N = 128
with 100 real nodes). Tolerances: loss 1e-5; gradients 1e-4 of the largest
entry of each tensor (f32 sums in another order through ~20 layers);
metrics over steps 1e-4; parameters after the last step 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.nn.diffusion import DiffusionLayer as JaxDiffusionLayer
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import dropout, init_parameters
from dgdm_histopath_torch.ops.graph import PaddedGraph
from dgdm_histopath_torch.training import (
    DGDMTrainer,
    TrainerConfig,
    make_lr_schedule,
    make_optimizer,
)
from test_torch_model import KW, _flat

N, N_REAL, B = 128, 100, 3
RNGS = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
        "masking": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}


def to_torch_graph(g) -> PaddedGraph:
    fields = {f: torch.from_numpy(np.array(getattr(g, f))) for f in
              ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")}
    fields["y"] = None if g.y is None else torch.from_numpy(np.array(g.y))
    return PaddedGraph(**fields)


def make_batch(y=None, filler=True):
    """B graphs of N nodes; the last one is a filler (all padding) when asked."""
    graphs = [make_synthetic_graph(seed=i, n_nodes=N, n_real=N_REAL, feat_dim=16)
              for i in range(B)]
    batch = j_batch(graphs)
    if filler:
        batch = batch.replace(node_mask=batch.node_mask.at[-1].set(False),
                              nbr_mask=batch.nbr_mask.at[-1].set(False))
    return batch if y is None else batch.replace(y=jnp.asarray(y))


def jax_draws(jm, params, batch, rngs, mask_ratio=0.15):
    """The draws of one JAX ``pretrain_step`` under ``rngs``, as torch tensors."""
    out, state = jm.apply(
        params, batch, mask_ratio=mask_ratio, deterministic=False,
        method=JaxDGDM.pretrain_step, rngs=rngs, mutable=["intermediates"],
        capture_intermediates=lambda m, name: (isinstance(m, JaxDiffusionLayer)
                                               and name == "__call__"))
    _, noise, t = state["intermediates"]["diffusion"]["__call__"][0]
    b, n = batch.node_mask.shape
    uniform = jax.random.uniform(jax.random.fold_in(rngs["masking"], 17), (b, n))
    return {"masked": torch.from_numpy(np.array(out["masked_nodes"])),
            "noise": torch.from_numpy(np.array(noise)),
            "t": torch.from_numpy(np.array(t)).long(),
            "uniform": torch.from_numpy(np.array(uniform))}


def torch_model(params, **kw):
    tm = DGDMModel(**{**KW, **kw})
    load_state(tm, params_from_flax(_flat(params)))
    return tm


def assert_tree_close(got: dict, ref: dict, rel: float, what: str):
    """Every tensor within ``rel`` of the reference tensor's largest entry.
    A tensor whose true value is zero (a key bias, which the softmax over
    its slots cancels) holds rounding noise on both sides; it is held to
    ``rel`` of a thousandth of the whole tree's largest entry."""
    assert set(got) == set(ref)
    floor = 1e-3 * max(float(v.abs().max()) for v in ref.values())
    for key in sorted(ref):
        r = ref[key].numpy()
        scale = max(float(np.abs(r).max()), floor)
        err = float(np.abs(got[key].detach().numpy() - r).max())
        assert err <= rel * scale, f"{what} {key}: {err:.3e} > {rel} * {scale:.3e}"


# ---------------------------------------------------------------------------
# pretrain_step: outputs, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pretrain_loss_and_every_parameter_gradient_match_jax_grad(impl):
    """``impl`` is the JAX side's gather formulation; "pallas" runs the Pallas
    gathers and the Pallas gather_rows backward in interpret mode. Its
    kernels need N to tile by 128, which the pooled U-Net levels (64, 32
    nodes) do not, so that case runs without the U-Net."""
    batch = make_batch()
    kw = {**KW, "use_hierarchical": impl != "pallas"}
    jm = JaxDGDM(**kw, gather_impl=impl)
    cfg = jtr.TrainerConfig()
    jt = jtr.DGDMTrainer(jm, cfg, use_mesh=False)
    with jax.default_matmul_precision("float32"):
        params = jm.init(RNGS, batch, mode="pretrain", deterministic=True)
        draws = jax_draws(jm, params, batch, RNGS)
        out_ref = jm.apply(params, batch, mask_ratio=cfg.masking_ratio, deterministic=False,
                           method=JaxDGDM.pretrain_step, rngs=RNGS)
        (loss_ref, metrics_ref), grads_ref = jax.value_and_grad(
            lambda p: jt._pretrain_losses(p, batch, RNGS), has_aux=True)(params)

    tm = torch_model(params, use_hierarchical=kw["use_hierarchical"])
    tbatch = to_torch_graph(batch)
    out = tm.pretrain_step(tbatch, mask_ratio=cfg.masking_ratio, deterministic=False,
                           masked=draws["masked"], t=draws["t"], noise=draws["noise"])
    assert torch.equal(out["masked_nodes"], draws["masked"])
    assert torch.equal(out["diffusion_t"], draws["t"])
    for key in ("diffusion_loss", "reconstruction_loss"):
        np.testing.assert_allclose(float(out[key].detach()), float(out_ref[key]), atol=1e-5,
                                   rtol=1e-5)
    for key in ("node_embeddings", "reconstruction", "graph_embedding"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(out_ref[key]),
                                   atol=1e-4, rtol=1e-4)

    tt = DGDMTrainer(tm, TrainerConfig(), device="cpu")
    loss, metrics = tt._pretrain_losses(tbatch, draws)
    assert set(metrics) == set(metrics_ref)
    for key, ref in metrics_ref.items():
        np.testing.assert_allclose(float(metrics[key].detach()), float(ref), atol=1e-5,
                                   rtol=1e-5)
    loss.backward()
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in tm.named_parameters()}
    assert all(g.dtype == torch.float32 for g in got.values())
    assert_tree_close(got, params_from_flax(_flat(grads_ref)), 1e-4, "gradient")


def test_pretrain_draws_come_from_the_generator_and_mask_only_real_nodes():
    tm = init_parameters(DGDMModel(**KW), torch.Generator().manual_seed(0))
    tbatch = to_torch_graph(make_batch())
    a = tm.pretrain_step(tbatch, mask_ratio=0.5, generator=torch.Generator().manual_seed(1))
    b = tm.pretrain_step(tbatch, mask_ratio=0.5, generator=torch.Generator().manual_seed(1))
    c = tm.pretrain_step(tbatch, mask_ratio=0.5, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a["masked_nodes"], b["masked_nodes"])
    assert torch.equal(a["diffusion_loss"], b["diffusion_loss"])
    assert not torch.equal(a["masked_nodes"], c["masked_nodes"])
    assert not (a["masked_nodes"] & ~tbatch.node_mask).any()
    frac = a["masked_nodes"][:2].float().sum() / tbatch.node_mask[:2].float().sum()
    assert 0.3 < float(frac) < 0.7
    corrupted = tm.apply_entity_masking(tbatch, masked=a["masked_nodes"])
    assert torch.equal(corrupted.x[a["masked_nodes"]],
                       tm.mask_token.detach().expand(int(a["masked_nodes"].sum()), -1))
    assert torch.equal(corrupted.x[~a["masked_nodes"]], tbatch.x[~a["masked_nodes"]])
    emb = tm.generate_embeddings(tbatch)
    assert emb.shape == (B, 16) and not emb.requires_grad


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {
    "cosine": dict(scheduler_type="cosine", warmup_steps=5, steps_per_epoch=10,
                   max_epochs=4, pretrain_epochs=2),
    "cosine_no_warmup": dict(scheduler_type="cosine", warmup_steps=0, steps_per_epoch=10,
                             max_epochs=4, pretrain_epochs=2),
    "cosine_long_warmup": dict(scheduler_type="cosine", warmup_steps=100, steps_per_epoch=10,
                               max_epochs=4, pretrain_epochs=2),
    "onecycle": dict(scheduler_type="onecycle", steps_per_epoch=10, max_epochs=4,
                     pretrain_epochs=2),
    "none": dict(scheduler_type="none", steps_per_epoch=10, max_epochs=4, pretrain_epochs=1,
                 finetune_lr_factor=0.5),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(case):
    """Across warmup, the x``finetune_lr_factor`` drop at the phase switch
    and past the horizon; relative 1e-5 (optax evaluates in f32)."""
    kw = SCHEDULES[case]
    ref = jtr.make_lr_schedule(jtr.TrainerConfig(learning_rate=3e-4, **kw))
    out = make_lr_schedule(TrainerConfig(learning_rate=3e-4, **kw))
    steps = [0, 1, 2, 4, 5, 6, 9, 10, 11, 12, 19, 20, 21, 30, 39, 40, 41, 100, 101, 500]
    np.testing.assert_allclose([out(s) for s in steps],
                               [float(ref(jnp.asarray(s))) for s in steps],
                               rtol=1e-5, atol=1e-12)
    if kw.get("warmup_steps", 0) > 0 and kw["scheduler_type"] == "cosine":
        assert out(0) == 0.0                       # the first update leaves parameters alone


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="unknown scheduler_type"):
        make_lr_schedule(TrainerConfig(scheduler_type="step"))


def test_update_rule_matches_optax_clip_then_adamw():
    """One tensor, three steps, gradients above and below the clip norm."""
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, gradient_clip_val=1.0,
               scheduler_type="none")
    rs = np.random.RandomState(0)
    p0 = rs.randn(7, 3).astype(np.float32)
    grads = [rs.randn(7, 3).astype(np.float32) * s for s in (10.0, 0.01, 1.0)]
    tx = jtr.make_optimizer(jtr.TrainerConfig(**cfg))
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(TrainerConfig(**cfg), [tp])
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = torch.from_numpy(g.copy())
        norm = torch.linalg.vector_norm(tg)
        tp.grad = tg * torch.where(norm < 1.0, torch.ones(()), 1.0 / norm)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# whole steps of the two trainers
# ---------------------------------------------------------------------------

TASKS = {   # case -> (model head overrides, labels)
    "classification": (dict(num_classes=3, regression_targets=0, survival_mode=None),
                       np.array([2, 0, 1], np.int32)),
    "regression": (dict(num_classes=None, regression_targets=2, survival_mode=None),
                   np.array([[0.5, -1.0], [2.0, 0.3], [0.0, 0.0]], np.float32)),
    "cox": (dict(num_classes=None, regression_targets=0, survival_mode="cox"),
            np.array([[5.0, 1.0], [3.0, 1.0], [9.0, 0.0]], np.float32)),
    "discrete": (dict(num_classes=None, regression_targets=0, survival_mode="discrete"),
                 np.array([[2.0, 1.0], [1.0, 0.0], [3.0, 1.0]], np.float32)),
    "unlabeled": (dict(num_classes=2, regression_targets=0, survival_mode=None), None),
}


SHIFT_INVARIANT_BIASES = ("k_proj.bias", "survival_head.risk.bias")


@pytest.mark.parametrize("case", sorted(TASKS))
def test_trainer_steps_match_the_jax_trainer(case):
    """3 pretrain steps then 2 finetune steps, one filler graph in the batch:
    every metric of every step within 1e-4, parameters after the last step
    within 1e-5. The first update has learning rate 0 (warmup from 0).

    The shift-invariant biases are the exception: the softmax over the keys
    cancels a key bias (``k_proj.bias``, ``edge_k_proj.bias``) and Cox's
    partial likelihood cancels the risk bias, so their true gradient is zero
    and both sides hold rounding noise, which Adam normalises into steps of
    the size of the learning rate. They cannot move any loss; they are held
    to the sum of the steps' learning rates."""
    heads, y = TASKS[case]
    kw = {**KW, **heads}
    cfg = dict(learning_rate=1e-3, warmup_steps=2, steps_per_epoch=3, pretrain_epochs=1,
               max_epochs=2)
    batch = make_batch(y)
    jm = JaxDGDM(**kw, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**cfg), use_mesh=False)
    with jax.default_matmul_precision("float32"):
        state = jt.init_state(jax.random.PRNGKey(11), batch)
        params0 = jax.device_get(state.params)
        state_rng = jnp.asarray(np.array(state.rng))   # the step donates its state

        tm = torch_model(params0, **heads)
        tt = DGDMTrainer(tm, TrainerConfig(**cfg), device="cpu")
        tt.init_state(seed=0)
        assert tt.task == jt.task
        tbatch = to_torch_graph(batch)
        before = {k: v.clone() for k, v in tm.state_dict().items()}

        for step, epoch in enumerate([0, 0, 0, 1, 1]):
            rng = jax.random.fold_in(state_rng, step)
            rngs = {"diffusion": jax.random.fold_in(rng, 0),
                    "masking": jax.random.fold_in(rng, 1),
                    "dropout": jax.random.fold_in(rng, 2)}
            draws = jax_draws(jm, params0, batch, rngs)
            ref = jt.training_step(batch, epoch)
            got = tt.training_step(tbatch, epoch, draws=draws)
            assert set(got) == set(ref), (step, set(got) ^ set(ref))
            for key in ref:
                np.testing.assert_allclose(got[key], ref[key], atol=1e-4, rtol=1e-4,
                                           err_msg=f"step {step} {key}")
            if step == 0:
                assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
        assert tt.step == 5 and int(jt.state.step) == 5
    ref_params = params_from_flax(_flat(jax.device_get(jt.state.params)))
    got_params = dict(tm.named_parameters())
    assert set(got_params) == set(ref_params)
    moved = 0.0
    lr_sum = sum(tt.lr_schedule(s) for s in range(5))
    for key, ref in ref_params.items():
        atol = lr_sum if key.endswith(SHIFT_INVARIANT_BIASES) else 1e-5
        np.testing.assert_allclose(got_params[key].detach().numpy(), ref.numpy(), atol=atol,
                                   rtol=0, err_msg=key)
        moved = max(moved, float((got_params[key].detach() - before[key]).abs().max()))
    assert moved > 1e-4                            # the steps did move the parameters


def test_validation_step_matches_the_jax_trainer():
    heads, y = TASKS["classification"]
    batch = make_batch(y)
    jm = JaxDGDM(**{**KW, **heads}, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(pretrain_epochs=1), use_mesh=False)
    with jax.default_matmul_precision("float32"):
        state = jt.init_state(jax.random.PRNGKey(5), batch)
        rng = jax.random.fold_in(state.rng, 999)
        draws = jax_draws(jm, state.params, batch,
                          {"diffusion": rng, "masking": jax.random.fold_in(rng, 1)})
        ref_pre = jt.validation_step(batch, epoch=0)
        ref_fin = jt.validation_step(batch, epoch=1)
    tt = DGDMTrainer(torch_model(state.params, **heads), TrainerConfig(pretrain_epochs=1),
                     device="cpu")
    tt.init_state(0)
    tbatch = to_torch_graph(batch)
    got_pre = tt.validation_step(tbatch, epoch=0, draws=draws)
    got_fin = tt.validation_step(tbatch, epoch=1)
    np.testing.assert_allclose(float(got_pre["loss"]), float(ref_pre["loss"]), atol=1e-5,
                               rtol=1e-5)
    assert set(got_fin) == set(ref_fin)
    for key in ref_fin:
        np.testing.assert_allclose(got_fin[key].numpy(), np.asarray(ref_fin[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    # same seed, same validation draws; nothing moves the parameters
    again = tt.validation_step(tbatch, epoch=0)
    assert torch.equal(again["loss"], tt.validation_step(tbatch, epoch=0)["loss"])
    out = tt.predict_step(tbatch)
    assert "attention_weights" in out and not out["classification_logits"].requires_grad


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_function_is_seeded_scaled_and_mean_preserving():
    x = torch.ones(200, 500)
    a = dropout(x, 0.25, torch.Generator().manual_seed(0))
    torch.manual_seed(9)                           # the global generator is not read
    b = dropout(x, 0.25, torch.Generator().manual_seed(0))
    c = dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.unique().tolist() == [0.0, float(np.float32(1.0) / np.float32(0.75))]
    assert abs(float(a.mean()) - 1.0) < 0.01
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.01
    assert dropout(x, 0.0, None) is x


def test_model_dropout_follows_the_generator_and_is_off_when_deterministic():
    tm = init_parameters(DGDMModel(**{**KW, "dropout": 0.2}), torch.Generator().manual_seed(0))
    tbatch = to_torch_graph(make_batch(filler=False))

    def logits(**kw):
        with torch.no_grad():
            return tm(tbatch, mode="finetune", **kw)["classification_logits"]

    base = logits(deterministic=True)
    assert torch.equal(base, logits(deterministic=True,
                                    generator=torch.Generator().manual_seed(3)))
    a = logits(deterministic=False, generator=torch.Generator().manual_seed(3))
    b = logits(deterministic=False, generator=torch.Generator().manual_seed(3))
    c = logits(deterministic=False, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, base) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    no_dropout = DGDMModel(**KW)
    no_dropout.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert torch.equal(no_dropout(tbatch, deterministic=False)["classification_logits"],
                           base)


def test_trainer_steps_replay_from_seed_and_step():
    """The step's draws follow from (seed, step): two trainers with one seed
    take the same steps; another seed takes others."""
    tbatch = to_torch_graph(make_batch())
    cfg = TrainerConfig(warmup_steps=0, steps_per_epoch=2, pretrain_epochs=1)

    def run(seed):
        tm = init_parameters(DGDMModel(**{**KW, "dropout": 0.1}),
                             torch.Generator().manual_seed(0))
        tt = DGDMTrainer(tm, cfg, device="cpu")
        tt.init_state(seed)
        return [tt.training_step(tbatch, 0) for _ in range(2)], tt

    a, tt = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert a == b and a[0] != a[1] and a[0] != c[0]
    assert all(np.isfinite(v) for m in a for v in m.values()) and a[0]["grad_norm"] > 0
    assert set(a[0]) == {"diffusion_loss", "reconstruction_loss", "contrastive_loss", "loss",
                         "grad_norm"}
    # a run that resumes at step s replays the draws of step s: with the
    # parameters frozen (rate 0), going back to step 0 repeats its metrics
    frozen = DGDMTrainer(tt.model, TrainerConfig(learning_rate=0.0, weight_decay=0.0,
                                                 scheduler_type="none", pretrain_epochs=1),
                         device="cpu")
    frozen.init_state(0)
    first, second = frozen.training_step(tbatch, 0), frozen.training_step(tbatch, 0)
    frozen.step = 0
    assert frozen.training_step(tbatch, 0) == first and first != second


# ---------------------------------------------------------------------------
# surface
# ---------------------------------------------------------------------------

def test_unported_trainer_options_raise_naming_the_roadmap(monkeypatch, tmp_path):
    """A mesh with a ``model`` axis raises naming item 12; gradient
    accumulation is taken; the fit options of item 11 (a checkpoint
    manager, a train logger, a preemption guard, a mid-epoch start) are
    ported and taken; ``TrainerConfig.from_config`` reads a config."""
    from dgdm_histopath_torch.parallel import make_mesh
    from dgdm_histopath_torch.training import CheckpointManager, PreemptionGuard, TrainLogger
    from dgdm_histopath_torch.utils.config import DGDMConfig

    model = DGDMModel(**KW)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 12"):
        DGDMTrainer(model, device="cpu", mesh=make_mesh(axes=("data", "model"), shape=(1, 2)))
    tt = DGDMTrainer(model, TrainerConfig(accumulate_grad_batches=4), device="cpu")
    tt.init_state(0)
    before = [p.detach().clone() for p in tt.params]
    tt.training_step(to_torch_graph(make_batch()), 0)
    assert tt.mini_step == 1 and all(torch.equal(p, q) for p, q in zip(tt.params, before))
    tt = DGDMTrainer(model, device="cpu")
    with pytest.raises(RuntimeError, match="init_state"):
        tt.training_step(to_torch_graph(make_batch()))
    tt.init_state(0)
    batch = to_torch_graph(make_batch())
    mgr = CheckpointManager(tmp_path / "ckpt")
    logger = TrainLogger(tmp_path / "logs", logger_type="none")
    guard = PreemptionGuard(install=False)
    guard.trigger()
    stopped = tt.fit([batch, batch], val_loader=[batch], max_epochs=1,
                     checkpoint_manager=mgr, train_logger=logger, preemption_guard=guard)
    assert stopped["interrupted"] and tt.step == 1
    assert mgr.record_extra()["resume"] == {"epoch": 0, "step_in_epoch": 1, "mid_epoch": True}
    done = tt.fit([batch, batch], val_loader=[batch], max_epochs=1, checkpoint_manager=mgr,
                  train_logger=logger, start_step_in_epoch=1)
    logger.close()
    assert not done["interrupted"] and done["history"][-1]["steps"] == 2 and tt.step == 2
    assert mgr.all_steps() == [0] and (tmp_path / "logs" / "metrics.csv").exists()
    cfg = DGDMConfig()
    cfg.training.learning_rate, cfg.advanced.gradient_clip_val = 3e-4, 0.5
    from_cfg = TrainerConfig.from_config(cfg)
    assert (from_cfg.learning_rate, from_cfg.gradient_clip_val) == (3e-4, 0.5)
    assert from_cfg.max_epochs == cfg.training.max_epochs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DGDMTrainer(model)


def test_fit_switches_phase_validates_and_restores_the_best_parameters():
    heads, y = TASKS["classification"]
    tm = init_parameters(DGDMModel(**{**KW, **heads}), torch.Generator().manual_seed(0))
    tbatch = to_torch_graph(make_batch(y))
    tt = DGDMTrainer(tm, TrainerConfig(learning_rate=1e-3, warmup_steps=0, steps_per_epoch=2,
                                       pretrain_epochs=1, max_epochs=2), device="cpu")
    tt.init_state(0)
    result = tt.fit([tbatch, tbatch], val_loader=[tbatch], restore_best_params=True)
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["pretrain", "finetune"]
    assert [h["steps"] for h in hist] == [2, 2] and tt.step == 4
    assert "train_contrastive_loss" in hist[0] and "train_accuracy" in hist[1]
    assert "val_accuracy" in hist[1] and "val_accuracy" not in hist[0]
    assert result["best_val_loss"] == min(h["val_loss"] for h in hist)
    assert result["interrupted"] is False
    embs = tt.generate_embeddings([tbatch, tbatch])
    assert embs.shape == (2 * B, 16) and np.isfinite(embs).all()


def test_fit_stops_early_in_finetune_and_reports_the_c_index():
    heads, y = TASKS["cox"]
    tm = init_parameters(DGDMModel(**{**KW, **heads}), torch.Generator().manual_seed(0))
    tbatch = to_torch_graph(make_batch(y, filler=False))
    tt = DGDMTrainer(tm, TrainerConfig(learning_rate=0.0, scheduler_type="none",
                                       steps_per_epoch=1, pretrain_epochs=0, max_epochs=6),
                     device="cpu")
    tt.init_state(0)
    result = tt.fit([tbatch], val_loader=[tbatch], early_stopping_patience=2)
    # rate 0: validation never improves after the first epoch
    assert len(result["history"]) == 3
    assert 0.0 <= result["history"][0]["val_cindex"] <= 1.0
