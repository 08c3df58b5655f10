"""Data parallelism and gradient accumulation in the port, on the CPU.

Two ranks over a gloo group (spawned, meeting at a ``file://`` rendezvous
under ``tmp_path``; tests/torch_dp_worker.py) against one process on the
global batch, and against the JAX trainer on a 2-device ``data`` mesh with
the same draws: losses 1e-5 against the single process, metrics 1e-4 and
parameters 1e-5 against JAX (the tolerances of
test_trainer_steps_match_the_jax_trainer, the shift-invariant key biases
held to the steps' summed learning rate as there). An odd batch is filled
up with a filler graph. The explicit-collective step against JAX
``make_spmd_train_step``. ``accumulate_grad_batches=2`` against
``optax.MultiSteps`` and a resume between mini-steps, bit-equal. The
datamodule shards by node; two nodes of one rank (``LOCAL_WORLD_SIZE=1``)
train on the stack of their batches, and ``fit`` brings their batches to
one shape a step. ``cli.train --mesh-shape 2 --device cpu``
against ``--mesh-shape 1``, and SIGTERM -> 75 -> ``resume`` bit-equal.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dgdm_histopath_tpu.parallel.mesh import shard_batch as jax_shard_batch
from dgdm_histopath_tpu.parallel.spmd_step import make_spmd_train_step as jax_spmd_step
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.cli import train as ttrain
from dgdm_histopath_torch.convert import params_from_flax
from dgdm_histopath_torch.data import HistopathDataModule, HistopathDataset, save_graph
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.parallel import make_mesh, pad_batch_to_devices, shard_batch
from dgdm_histopath_torch.training import (
    CheckpointManager,
    DGDMTrainer,
    TrainerConfig,
    make_optimizer,
)
from dgdm_histopath_torch.training.losses import contrastive_loss
from dgdm_histopath_torch.training.trainer import clip_and_step
from test_torch_model import KW, _flat
from test_torch_training import SHIFT_INVARIANT_BIASES, jax_draws, to_torch_graph
from torch_dp_worker import spawn_ranks

REPO = Path(__file__).resolve().parents[1]
HEADS = dict(num_classes=3, regression_targets=0, survival_mode=None)
MODEL = {**KW, **HEADS}
CFG = dict(learning_rate=1e-3, warmup_steps=1, steps_per_epoch=3, pretrain_epochs=1,
           max_epochs=2)
EPOCHS = [0, 0, 0, 1, 1]


def jax_batch(b, y, filler=False):
    graphs = [make_synthetic_graph(seed=i, n_nodes=128, n_real=100, feat_dim=16)
              for i in range(b)]
    batch = j_batch(graphs).replace(y=jnp.asarray(y))
    if filler:
        batch = batch.replace(node_mask=batch.node_mask.at[-1].set(False),
                              nbr_mask=batch.nbr_mask.at[-1].set(False))
    return batch


def single_run(state, steps, validate=(), model=MODEL, config=CFG, moe_group=None):
    tm = DGDMModel(**model)
    tm.load_state_dict(state)
    if moe_group:
        tm.moe_ffn.group_size = moe_group
    tt = DGDMTrainer(tm, TrainerConfig(**config), device="cpu")
    tt.init_state(0)
    metrics = [tt.training_step(b, e, draws=d) for b, e, d in steps]
    val = [tt.validation_step(b, e, draws=d) for b, e, d in validate]
    return {"metrics": metrics, "validation": val,
            "params": {k: v.detach().clone() for k, v in tm.named_parameters()}}


def assert_params_close(got, ref, lr_sum, what):
    assert set(got) == set(ref)
    for key, r in ref.items():
        atol = lr_sum if key.endswith(SHIFT_INVARIANT_BIASES) else 1e-5
        np.testing.assert_allclose(got[key].numpy(), r.numpy(), atol=atol, rtol=0,
                                   err_msg=f"{what} {key}")


def node_datasets():
    """9 labelled graphs of two buckets, (32 nodes, 4 neighbours) and (64,
    8), for two nodes: their shards make batches of 2 of different counts
    and shapes. ``resume_at`` is the smaller count: a run resumed there
    finds one node's loader empty at once."""
    graphs = []
    for i in range(9):
        big = i % 2
        g = make_synthetic_graph(n_nodes=32 << big, n_real=24 << big, k=4 << big, feat_dim=16,
                                 seed=i, num_classes=3)
        graphs.append(to_torch_graph(g))
    seed = 0
    counts = [len(list(HistopathDataModule(
        graphs, batch_size=2, train_split=1.0, val_split=0.0, test_split=0.0, seed=seed,
        num_shards=2, shard_index=i).train_dataloader())) for i in (0, 1)]
    assert counts[0] != counts[1], counts
    return {"graphs": graphs, "seed": seed, "epochs": 2, "batches": counts,
            "resume_at": min(counts)}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """One spawn of 2 gloo ranks runs every scenario; the references are
    computed here: the JAX trainer on a 2-device data mesh, JAX's
    explicit-collective step, and the port in one process."""
    tmp = tmp_path_factory.mktemp("dp")
    y4 = np.array([2, 0, 1, 1], np.int32)
    batch4 = jax_batch(4, y4)
    jm = JaxDGDM(**MODEL, gather_impl="xla")
    mesh = jax_make_mesh(n_devices=2)
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**CFG), mesh=mesh)
    ref = {"jax": [], "draws": []}
    with jax.default_matmul_precision("float32"):
        state = jt.init_state(jax.random.PRNGKey(11), batch4)
        params0 = jax.device_get(state.params)
        state_rng = jnp.asarray(np.array(state.rng))
        for step, epoch in enumerate(EPOCHS):
            rng = jax.random.fold_in(state_rng, step)
            rngs = {"diffusion": jax.random.fold_in(rng, 0),
                    "masking": jax.random.fold_in(rng, 1), "dropout": jax.random.fold_in(rng, 2)}
            ref["draws"].append(jax_draws(jm, params0, batch4, rngs) if epoch == 0 else None)
            ref["jax"].append(jt.training_step(batch4, epoch))
        ref["jax_params"] = params_from_flax(_flat(jax.device_get(jt.state.params)))

        # the explicit-collective step on finetune losses (no draws)
        jt2 = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**CFG), mesh=mesh)
        st = jt2.init_state(jax.random.PRNGKey(11), batch4)
        step_fn = jax_spmd_step(jt2._finetune_losses, jt2.tx, mesh)
        sharded = jax_shard_batch(batch4, mesh)
        ref["spmd"] = []
        for _ in range(2):
            st, m = step_fn(st, sharded)
            ref["spmd"].append({k: float(v) for k, v in m.items()})
        ref["spmd_params"] = params_from_flax(_flat(jax.device_get(st.params)))

    state0 = params_from_flax(_flat(params0))
    t4 = to_torch_graph(batch4)
    t3 = to_torch_graph(jax_batch(3, y4[:3], filler=True))
    g3 = torch.Generator().manual_seed(3)
    n, hidden = 128, KW["hidden_dims"][-1]
    draws3 = {"masked": (torch.rand(3, n, generator=g3) < 0.15) & t3.node_mask,
              "t": torch.randint(0, 3, (3,), generator=g3),
              "noise": torch.randn(3, n, hidden, generator=g3),
              "uniform": torch.rand(3, n, generator=g3)}
    moe_model = {**MODEL, "moe_experts": 4}
    moe_state = DGDMModel(**moe_model).state_dict()
    moe_state.update(state0)
    torch.manual_seed(0)
    for k in ("moe_ffn.w_in", "moe_ffn.w_out", "moe_ffn.router.weight"):
        moe_state[k] = torch.randn_like(moe_state[k]) * 0.2
    acc_cfg = {**CFG, "accumulate_grad_batches": 2, "warmup_steps": 0}
    # two nodes of one rank: each loads its own batch of 4, the global batch is 8
    t8 = to_torch_graph(jax_batch(8, np.array([2, 0, 1, 1, 0, 2, 2, 1], np.int32)))
    halves = [t8.replace(**{f: getattr(t8, f)[lo:lo + 4] for f in
                            ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y")})
              for lo in (0, 4)]
    node_epochs = [0, 0, 1]
    scenarios = {
        "jax": dict(steps=[(t4, e, d) for e, d in zip(EPOCHS, ref["draws"])],
                    validate=[(t4, 0, ref["draws"][0]), (t4, 1, None)]),
        "odd": dict(steps=[(t3, 0, draws3), (t3, 0, draws3), (t3, 1, None)],
                    validate=[(t3, 1, None)]),
        "generator": dict(steps=[(t4, 0, None), (t4, 0, None), (t4, 1, None)],
                          validate=[(t4, 0, None)]),
        "accumulate": dict(steps=[(t4, 0, None)] * 4, config=acc_cfg),
        "moe": dict(steps=[(t4, 0, None), (t4, 1, None)], model=moe_model, state=moe_state,
                    moe_group=128),
        "two_nodes": dict(steps=[(t8, e, None) for e in node_epochs],
                          rank_steps=[[(h, e, None) for e in node_epochs] for h in halves],
                          validate=[(t8, 1, None)], env={"LOCAL_WORLD_SIZE": "1"}),
    }
    specs = []
    for name, sc in scenarios.items():
        spec = {"job": "train_steps", "model": sc.get("model", MODEL),
                "state": sc.get("state", state0), "config": sc.get("config", CFG),
                "steps": sc["steps"], "validate": sc.get("validate", []),
                "moe_group": sc.get("moe_group"), "env": sc.get("env", {})}
        if "rank_steps" in sc:
            spec["rank_steps"] = sc["rank_steps"]
        specs.append(spec)
    nodes = node_datasets()
    specs.append({"job": "fit_nodes", **nodes, "model": MODEL, "state": state0,
                  "config": CFG, "env": {"LOCAL_WORLD_SIZE": "1"}})
    specs.append({"job": "spmd_steps", "model": MODEL, "state": state0, "config": CFG,
                  "steps": [(t4, 1, None)] * 2})
    specs.append({"job": "gather_check"})
    specs.append({"job": "train_steps", "model": moe_model, "state": moe_state,
                  "config": CFG, "steps": [(t4, 0, None)], "expect_error": True})
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, specs, tmp)
    spawn_s = time.perf_counter() - t0
    names = list(scenarios)
    got = {name: [r[i] for r in ranks] for i, name in enumerate(names)}
    got["fit_nodes"] = [r[len(names)] for r in ranks]
    got["spmd"] = [r[len(names) + 1] for r in ranks]
    got["gather"] = [r[len(names) + 2] for r in ranks]
    got["straddle"] = [r[len(names) + 3] for r in ranks]
    single = {name: single_run(sc.get("state", state0), sc["steps"], sc.get("validate", ()),
                               model=sc.get("model", MODEL), config=sc.get("config", CFG),
                               moe_group=sc.get("moe_group"))
              for name, sc in scenarios.items()}
    return {"ref": ref, "got": got, "single": single, "state0": state0, "t4": t4,
            "nodes": nodes, "spawn_s": spawn_s}


@pytest.mark.parametrize("scenario", ["jax", "odd", "generator", "accumulate", "moe",
                                      "two_nodes"])
def test_two_ranks_equal_one_process_on_the_global_batch(dp, scenario):
    """Both ranks report the same metrics; each step's metrics within 1e-5
    of the single process's, parameters within 1e-5 (the shift-invariant
    biases to the steps' learning rates); validation within 1e-5."""
    r0, r1 = dp["got"][scenario]
    single = dp["single"][scenario]
    assert r0["metrics"] == r1["metrics"]
    for i, (a, b) in enumerate(zip(r0["metrics"], single["metrics"])):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{scenario} step {i} {key}")
    for a, b in zip(r0["validation"], single["validation"]):
        for key in b:          # the ranks' rows of a padded batch hold its filler too
            got = a[key][:b[key].shape[0]] if b[key].dim() else a[key]
            np.testing.assert_allclose(got.numpy(), b[key].numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{scenario} validation {key}")
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    assert_params_close(r0["params"], single["params"], 3 * CFG["learning_rate"], scenario)
    if scenario == "moe":
        assert all("moe_aux_loss" in m for m in r0["metrics"])


def test_two_nodes_fit_trains_every_graph_each_node_loaded(dp):
    """Two nodes of one rank, each loading its own shard (3 and 2 batches
    of 2, of two bucket shapes): every step runs one shape on both ranks,
    an epoch lasts as long as the longer node's loader, and together the
    ranks train on each of the 9 graphs once an epoch. (With the global
    rank cutting each node's batch, half of every batch was left out.) A
    run resumed where one node's loader is already empty stands in filler
    graphs there."""
    r0, r1 = dp["got"]["fit_nodes"]
    info = dp["nodes"]
    assert (r0["shard"], r1["shard"]) == (0, 1) and r0["loaded"] + r1["loaded"] == 9
    longest, epochs = max(info["batches"]), info["epochs"]
    for run, steps in (("whole", longest * epochs),
                       ("resumed", longest * epochs - info["resume_at"])):
        a, b = r0[run], r1[run]
        assert len(a["seen"]) == len(b["seen"]) == steps, run
        assert [shape for shape, _ in a["seen"]] == [shape for shape, _ in b["seen"]]
        for ha, hb in zip(a["history"], b["history"]):
            assert {k: v for k, v in ha.items() if k != "epoch_time_s"} == \
                {k: v for k, v in hb.items() if k != "epoch_time_s"}
            assert all(np.isfinite(v) for k, v in ha.items() if k.startswith("train_"))
    for epoch in range(epochs):
        one = slice(epoch * longest, (epoch + 1) * longest)
        assert sum(n for _, n in r0["whole"]["seen"][one] + r1["whole"]["seen"][one]) == 9
    short = int(np.argmin(info["batches"]))
    resumed = (r0, r1)[short]["resumed"]["seen"]
    assert all(n == 0 for _, n in resumed[:longest - info["resume_at"]])


def test_two_ranks_match_the_jax_trainer_on_a_data_mesh(dp):
    got, ref = dp["got"]["jax"][0], dp["ref"]
    for i, (a, b) in enumerate(zip(got["metrics"], ref["jax"])):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    lr_sum = sum(jtr.make_lr_schedule(jtr.TrainerConfig(**CFG))(s) for s in range(5))
    assert_params_close(got["params"], ref["jax_params"], float(lr_sum), "jax")
    assert got["step"] == 5


def test_infonce_takes_its_negatives_from_the_global_batch(dp):
    """The ranks' contrastive loss is the global batch's; with each rank's
    own negatives it would differ (so the step comparisons above would
    catch it)."""
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(4, 128, 16, generator=g)
    mask, uniform = dp["t4"].node_mask, torch.rand(4, 128, generator=g)
    whole = contrastive_loss(emb, mask, uniform=uniform)
    per_rank = [contrastive_loss(emb[i:i + 2], mask[i:i + 2], uniform=uniform[i:i + 2])
                for i in (0, 2)]
    assert abs(float(whole) - float(sum(per_rank)) / 2) > 1e-2
    got = dp["got"]["jax"][0]["metrics"][0]["contrastive_loss"]
    np.testing.assert_allclose(got, dp["ref"]["jax"][0]["contrastive_loss"], rtol=1e-5)


def test_explicit_collective_step_matches_jax_make_spmd_train_step(dp):
    r0, r1 = dp["got"]["spmd"]
    assert r0["metrics"] == r1["metrics"]
    for a, b in zip(r0["metrics"], dp["ref"]["spmd"]):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert_params_close(r0["params"], dp["ref"]["spmd_params"], 2 * CFG["learning_rate"],
                        "spmd")


def test_gather_reduce_and_agreement_collectives(dp):
    """``Mesh.gather`` stacks the ranks' rows in rank order; its backward
    sums the gradient over the ranks (here both ranks take the same loss
    over the gathered rows) and hands each rank that of its own rows;
    ``Mesh.any``; ``hierarchical_pmean``."""
    for rank, r in enumerate(dp["got"]["gather"]):
        assert torch.equal(r["gathered"], torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2))
        assert torch.equal(r["grad"], 2 * torch.arange(6.0 * rank, 6.0 * rank + 6).view(2, 3))
        assert r["any"] == [True, False] and float(r["mean"]) == 0.5
        assert r["mask"].tolist() == [True, True, False, True]


def test_moe_group_straddling_two_ranks_raises(dp):
    """4 graphs of 128 nodes route in one group of 512 tokens; 2 ranks of
    256 tokens would split it."""
    for r in dp["got"]["straddle"]:
        assert "straddle" in r["error"]


def test_mesh_axes_shapes_and_filler_graphs():
    """Every axis is taken (item 12): a mesh of more than one rank needs a
    process group of as many; the axes must be named apart."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(axes=("data", "model"), shape=(1, 2))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(axes=("data", "expert"), shape=(2, 2))
    with pytest.raises(ValueError, match="distinct"):
        make_mesh(axes=("data", "data"), shape=(1, 1))
    with pytest.raises(ValueError, match="equal|differ"):
        make_mesh(axes=("data",), shape=(1, 1))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(shape=(2,))
    one = make_mesh(axes=("data", "model"), shape=(1, 1))
    assert one.group is None and one.size == 1 and one.rank == 0
    assert DGDMTrainer(DGDMModel(**MODEL), device="cpu", mesh=one)._dp is None
    t3 = to_torch_graph(jax_batch(3, np.zeros(3, np.int32)))
    padded = pad_batch_to_devices(t3, 2)
    assert padded.x.shape[0] == 4 and torch.equal(padded.x[3], t3.x[2])
    assert not padded.node_mask[3].any() and not padded.nbr_mask[3].any()
    assert pad_batch_to_devices(padded, 2) is padded
    assert torch.equal(shard_batch(padded, one).x, padded.x)


def test_accumulate_grad_batches_matches_optax_multisteps():
    """Two mini-steps a update over three tensors and six calls: the
    parameters stay put between updates, the clip and AdamW see the mean
    gradient, and the rate follows the applied updates (warmup from 0)."""
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, gradient_clip_val=1.0,
               scheduler_type="cosine", warmup_steps=2, steps_per_epoch=3, max_epochs=2,
               pretrain_epochs=1, accumulate_grad_batches=2)
    rs = np.random.RandomState(0)
    p0 = [rs.randn(7, 3).astype(np.float32), rs.randn(5).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) * s for p in p0]
             for s in (10.0, 0.01, 1.0, 3.0, 0.5, 2.0)]
    tx = jtr.make_optimizer(jtr.TrainerConfig(**cfg))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    tt = DGDMTrainer(DGDMModel(**MODEL), TrainerConfig(**cfg), device="cpu")
    tt.init_state(0)
    tt.params, tt.optimizer = params, make_optimizer(tt.config, params)
    tt.accumulated = [torch.zeros_like(p) for p in params]
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        before = [p.detach().clone() for p in tt.params]
        tt._update([torch.from_numpy(x.copy()) for x in g])
        tt.step += 1
        for p, q in zip(tt.params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6, rtol=1e-6)
        if i % 2 == 0:
            assert all(torch.equal(p, b) for p, b in zip(tt.params, before))
    assert tt.lr_schedule(0) == 0.0 and tt.mini_step == 0 and tt.step == 6


def test_accumulation_resumes_between_mini_steps_bit_for_bit(tmp_path):
    t4 = to_torch_graph(jax_batch(4, np.array([0, 1, 2, 0], np.int32)))
    cfg = TrainerConfig(**{**CFG, "accumulate_grad_batches": 2, "warmup_steps": 0})
    state = DGDMModel(**MODEL).state_dict()

    def trainer():
        tm = DGDMModel(**MODEL)
        tm.load_state_dict(state)
        torch.manual_seed(0)
        for p in tm.parameters():
            p.data.add_(torch.randn_like(p) * 0.05)
        tt = DGDMTrainer(tm, cfg, device="cpu")
        tt.init_state(3)
        return tt

    whole = trainer()
    first = whole.training_step(t4, 0)
    rest = [whole.training_step(t4, 0) for _ in range(3)]
    cut = trainer()
    assert cut.training_step(t4, 0) == first
    assert cut.mini_step == 1 and any(a.any() for a in cut.accumulated)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(cut.state_dict(), step=0)
    resumed = trainer()
    resumed.load_state_dict(mgr.restore())
    assert resumed.mini_step == 1 and resumed.step == 1
    assert [resumed.training_step(t4, 0) for _ in range(3)] == rest
    for (k, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpcli")
    labels = {}
    for i in range(16):
        g = make_synthetic_graph(n_nodes=64, n_real=50, feat_dim=16, seed=i)
        save_graph(to_torch_graph(g), root / "data" / f"s{i:02d}_graph.npz")
        labels[f"s{i:02d}"] = i % 2
    (root / "labels.json").write_text(json.dumps(labels))
    cfg = {"data": {"train_split": 0.5, "val_split": 0.25, "test_split": 0.25,
                    "batch_size": 4},
           "training": {"max_epochs": 8, "pretrain_epochs": 4, "warmup_steps": 2},
           "logging": {"logger_type": "csv"},
           "model": {"node_features": 16, "hidden_dims": [32, 16], "attention_heads": 4,
                     "graph_layers": 1, "num_diffusion_steps": 3,
                     "compute_dtype": "float32", "dropout": 0.0,
                     "use_hierarchical": False, "use_spatial_attention": False}}
    (root / "config.json").write_text(json.dumps(cfg))
    return root


def test_datamodule_shards_by_node_not_by_rank(monkeypatch, graph_files):
    """Two ranks on one node share the node's shard: both loaders give the
    single process's global batches, and the ranks' rows make them up. By
    rank (the old sharding) each rank would load its own batch of the full
    size: twice the global batch, of other graphs."""
    ds = HistopathDataset(graph_files / "data", metadata_path=graph_files / "labels.json")
    kw = dict(batch_size=4, seed=7, shuffle_train=True, prefetch=0)
    single = [b for b in HistopathDataModule(ds, **kw).train_dataloader()]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for rank in range(2):
        monkeypatch.setattr(torch.distributed, "get_rank", lambda r=rank: r)
        dm = HistopathDataModule(ds, **kw)
        assert (dm.num_shards, dm.shard_index) == (1, 0)
        assert all(torch.equal(a.x, b.x) for a, b in zip(dm.train_dataloader(), single))
    old = [HistopathDataModule(ds, **kw, num_shards=2, shard_index=r).train_dataloader()
           for r in range(2)]
    old_global = torch.cat([next(iter(loader)).x for loader in old])
    assert old_global.shape[0] == 2 * single[0].x.shape[0]
    assert not torch.equal(old_global[:4], single[0].x)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")          # two nodes of one rank each
    assert (HistopathDataModule(ds, **kw).num_shards, HistopathDataModule(ds, **kw).shard_index
            ) == (2, 1)


def _cli(root, out, *extra):
    return ["train", "--config", str(root / "config.json"), "--data-dir", str(root / "data"),
            "--dataset-type", "graph", "--metadata", str(root / "labels.json"),
            "--num-classes", "2", "--seed", "0", "--log-level", "WARNING", "--device", "cpu",
            "--output-dir", str(root / out), *extra]


@pytest.fixture(autouse=True, scope="module")
def _package_loggers_put_back():
    """``dgdm-train``'s ``main`` calls ``setup_logging``, which stops each
    package's records at its own logger; put both loggers back as they
    were, so that the tests after this file still see the records through
    ``caplog``."""
    loggers = [logging.getLogger(n) for n in ("dgdm_histopath_torch", "dgdm_histopath_tpu")]
    saved = [(lg.level, lg.propagate, list(lg.handlers)) for lg in loggers]
    yield
    for lg, (level, propagate, handlers) in zip(loggers, saved):
        lg.setLevel(level)
        lg.propagate = propagate
        lg.handlers[:] = handlers


def test_cli_mesh_shape_2_on_the_cpu_matches_one_process_and_resumes(graph_files):
    """Rank 0 writes the outputs (the bundle within 1e-5 of one process's);
    a SIGTERM to the launcher stops both ranks at one step boundary (exit
    75); ``resume`` with the same argv ends with the whole run's bundle,
    equal to the bit."""
    root = graph_files
    assert ttrain.main(_cli(root, "one", "--mesh-shape", "1")) == 0
    assert ttrain.main(_cli(root, "two", "--mesh-shape", "2")) == 0
    assert (root / "two" / "history.json").exists()
    assert not (root / "two" / ttrain.RENDEZVOUS).exists()
    with np.load(root / "one" / "final_model.npz") as a, \
            np.load(root / "two" / "final_model.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)

    argv = _cli(root, "cut", "--mesh-shape", "2")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen([sys.executable, "-m", "dgdm_histopath_torch.cli.train", *argv],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    index = root / "cut" / "checkpoints" / "index.json"
    deadline = time.time() + 240
    while not index.exists() and proc.poll() is None and time.time() < deadline:
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    out = proc.communicate(timeout=240)[0].decode()
    assert proc.returncode == 75, out[-3000:]
    resume = json.loads(index.read_text())["records"][-1]["extra"]["resume"]
    assert resume["mid_epoch"] and resume["epoch"] >= 1
    resume_argv = ["resume", *argv[1:], "--checkpoint-dir", str(root / "cut" / "checkpoints")]
    assert ttrain.main(resume_argv) == 0
    with np.load(root / "two" / "final_model.npz") as a, \
            np.load(root / "cut" / "final_model.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files if k != "__meta__")


def test_cli_ranks_stopped_before_training_exit_130(graph_files):
    """A SIGTERM to the launcher once both ranks have set up their data,
    before or just as ``fit``'s guard takes over: the ranks exit 130 as one
    process does (or 75 if the guard was in place), and so does the
    launcher; a rank killed by the signal would make it exit 1."""
    argv = [*_cli(graph_files, "early", "--mesh-shape", "2")]
    argv[argv.index("--log-level") + 1] = "INFO"
    proc = subprocess.Popen([sys.executable, "-m", "dgdm_histopath_torch.cli.train", *argv],
                            cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ready, lines = 0, []
    for line in proc.stdout:
        lines.append(line)
        ready += "dataset:" in line
        if ready == 2:
            proc.send_signal(signal.SIGTERM)
            break
    out = "".join(lines) + proc.communicate(timeout=120)[0]
    assert ready == 2, out[-3000:]
    assert proc.returncode in (ttrain.EX_INTERRUPTED, ttrain.EX_TEMPFAIL), out[-3000:]
    assert ttrain.launcher_code([130, 130]) == ttrain.launcher_code([130, 75]) == 130
    assert ttrain.launcher_code([75, 75]) == 75 and ttrain.launcher_code([0, 0]) == 0
    assert ttrain.launcher_code([-15, 130]) == ttrain.launcher_code([1, 0]) == 1


def test_cli_world_size_and_the_inert_devices_option(graph_files):
    cfg = ttrain.merge_cli_config(ttrain.build_parser().parse_args(
        _cli(graph_files, "x", "--devices", "4")))
    assert cfg.hardware.devices == 4
    assert ttrain.world_size(cfg, torch.device("cpu")) == 1
    cfg = ttrain.merge_cli_config(ttrain.build_parser().parse_args(
        _cli(graph_files, "x", "--mesh-shape", "3")))
    assert ttrain.world_size(cfg, torch.device("cpu")) == 3
    with pytest.raises(ValueError, match="cards"):
        ttrain.world_size(cfg, torch.device("cuda"))
    cfg = ttrain.merge_cli_config(ttrain.build_parser().parse_args(
        _cli(graph_files, "x", "--mesh-shape", "2,2", "--mesh-axes", "data,expert")))
    assert ttrain.world_size(cfg, torch.device("cpu")) == 4
    assert cfg.hardware.mesh_axes == ["data", "expert"]


def test_clip_and_step_is_the_trainers_update_rule():
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    opt = make_optimizer(TrainerConfig(weight_decay=0.0), [p])
    norm = clip_and_step([p], opt, 0.1, 1.0)
    assert float(norm) == 5.0 and torch.allclose(p.grad, torch.tensor([0.6, 0.8, 0.0]))
    assert opt.param_groups[0]["lr"] == 0.1 and not torch.equal(p.detach(), torch.ones(3))
