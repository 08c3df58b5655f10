"""The port's two-phase curriculum (self-supervised pretraining, then
finetuning) against the JAX package's, f32 on the CPU.

(a) ``DGDMTrainer.fit`` over 2 pretrain + 3 finetune epochs of 3 steps (15
steps across the phase switch, validated every epoch) from the JAX trainer's
initial parameters, each step's draws those of the JAX step: the train draws
from ``fold_in(state.rng, step)``, the validation draws from
``fold_in(state.rng, 999)``. ``fit`` takes no draws; the test wraps
``DGDMTrainer._step`` and ``validation_step`` to pass them. Held: every
epoch's metrics within 1e-4, the rate applied at every step against the JAX
schedule within 1e-7, the parameters after the last pretrain epoch and at
the end within 1e-4 of each tensor's largest entry (the shift-invariant
biases, whose true gradient is zero, within the sum of the rates: see
``test_torch_training.py``).

(b) Every dropout site at rate 0.2 with the random keep-mask replaced, in
both packages, by one function of the element's position in the mask's
shape (``keep``): ``jax.random.bernoulli`` on the JAX side (flax
``nn.Dropout`` and the direct draws of the graph layer and the attention
reach it), the draw behind ``nn.layers.dropout`` on the port's. A training
forward's logits within 1e-5 and a pretrain step's gradients within 1e-4 of
each tensor's largest entry, over the model options that put dropout on
different paths. In one process the port keys a pooled level's masks to
the rows' nodes of the first level (``nn.layers.NodeRows``), a position the
JAX package's pooled draw does not know; there the stand-in takes the
element's position at the pooled level's own shape, as the JAX draw does.

(c) The harness's per-seed re-entry: the tiny c16 run over train seeds 0
and 1 in one process writes seed 1's arms equal to the bit to a fresh
process's run of seed 1 alone.

(d) ``scripts.compare_gate_runs``, which holds one gate run's arms to
another's seed by seed, on planted arms and on the committed c16 arms.
"""

import functools
import json
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.convert import params_from_flax, params_to_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from dgdm_histopath_torch.training import trainer as ttr
from test_torch_model import KW, _flat
from test_torch_training import (
    SHIFT_INVARIANT_BIASES,
    assert_tree_close,
    jax_draws,
    to_torch_graph,
    torch_model,
)

N = 128
CLS = dict(num_classes=2, regression_targets=0, survival_mode=None, pooling="attention")
CURRICULUM_MODEL = dict(CLS, use_hierarchical=False)
CURRICULUM = dict(learning_rate=1e-3, pretrain_epochs=2, max_epochs=5, steps_per_epoch=3,
                  warmup_steps=2, weight_decay=1e-3)
STEPS = CURRICULUM["max_epochs"] * CURRICULUM["steps_per_epoch"]
EPOCH_KEYS = ("phase", "train_loss", "train_diffusion_loss", "train_reconstruction_loss",
              "train_contrastive_loss", "train_accuracy", "train_grad_norm", "val_loss",
              "val_accuracy", "steps")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside the other
    test workers, more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seeds, labels, n_real):
    """One JAX batch of len(seeds) graphs of N nodes, ``n_real[i]`` real."""
    graphs = [make_synthetic_graph(seed=s, n_nodes=N, n_real=r, feat_dim=16)
              for s, r in zip(seeds, n_real)]
    return j_batch(graphs).replace(y=jnp.asarray(np.asarray(labels, np.int32)))


class Snapshots:
    """A ``train_logger`` that keeps each epoch's summary and the
    parameters at the end of each epoch."""

    def __init__(self, read):
        self.read, self.summaries, self.params = read, [], []

    def log_metrics(self, summary, step=None):
        self.summaries.append(dict(summary))
        self.params.append(self.read())


@pytest.fixture(scope="module")
def curriculum():
    """Both fits, run once: the JAX ``fit`` from ``init_state(PRNGKey(3))``,
    then the port's from the same parameters with the JAX steps' draws."""
    train = [_batch((10, 11, 12), (1, 0, 1), (100, 90, 80)),
             _batch((13, 14, 15), (0, 1, 0), (95, 100, 70)),
             _batch((16, 17, 18), (1, 1, 0), (85, 100, 100))]
    val = [_batch((19, 20), (0, 1), (100, 75))]
    jm = JaxDGDM(**{**KW, **CURRICULUM_MODEL}, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**CURRICULUM), use_mesh=False)
    with jax.default_matmul_precision("float32"):
        with pytest.MonkeyPatch.context() as mp:
            # the reference's own init_state, its model.init compiled as one
            # program instead of op by op (the same values; a third of the time)
            mp.setattr(JaxDGDM, "init", lambda self, rngs, batch, **kw: jax.jit(
                functools.partial(nn.Module.init, self, **kw))(rngs, batch))
            state = jt.init_state(jax.random.PRNGKey(3), train[0])
        params0 = jax.device_get(state.params)
        state_rng = jnp.asarray(np.array(state.rng))      # the steps donate the state
        pretrain_steps = CURRICULUM["pretrain_epochs"] * CURRICULUM["steps_per_epoch"]
        train_draws = []
        for step in range(pretrain_steps):
            rng = jax.random.fold_in(state_rng, step)
            train_draws.append(jax_draws(jm, params0, train[step % len(train)],
                                   {"diffusion": jax.random.fold_in(rng, 0),
                                    "masking": jax.random.fold_in(rng, 1),
                                    "dropout": jax.random.fold_in(rng, 2)}))
        vrng = jax.random.fold_in(state_rng, 999)
        val_draws = jax_draws(jm, params0, val[0], {"diffusion": vrng,
                                                    "masking": jax.random.fold_in(vrng, 1)})
        jlog = Snapshots(lambda: params_from_flax(_flat(jax.device_get(jt.state.params))))
        ref = jt.fit(train, val_loader=val, train_logger=jlog)
        schedule = jtr.make_lr_schedule(jtr.TrainerConfig(**CURRICULUM))
        ref_rates = [float(schedule(jnp.asarray(s))) for s in range(STEPS)]

    tm = torch_model(params0, **CURRICULUM_MODEL)
    tt = DGDMTrainer(tm, TrainerConfig(**CURRICULUM), device="cpu")
    tt.init_state(seed=0)
    tval = [to_torch_graph(b) for b in val]
    rates = []
    step_fn, val_fn, clip_fn = DGDMTrainer._step, DGDMTrainer.validation_step, ttr.clip_and_step

    def _step(self, batch, epoch, materialize, draws=None, plan=None):
        if draws is None and self.step < len(train_draws):
            draws = train_draws[self.step]
        return step_fn(self, batch, epoch, materialize, draws, plan)

    def validation_step(self, batch, epoch=None, draws=None):
        assert batch is tval[0]
        return val_fn(self, batch, epoch, val_draws if draws is None else draws)

    def clip_and_step(params, optimizer, lr, *args, **kwargs):
        rates.append(lr)
        return clip_fn(params, optimizer, lr, *args, **kwargs)

    tlog = Snapshots(lambda: {k: v.detach().clone() for k, v in tm.named_parameters()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DGDMTrainer, "_step", _step)
        mp.setattr(DGDMTrainer, "validation_step", validation_step)
        mp.setattr(ttr, "clip_and_step", clip_and_step)
        got = tt.fit([to_torch_graph(b) for b in train], val_loader=tval,
                     train_logger=tlog)
    return {"ref": ref, "got": got, "jlog": jlog, "tlog": tlog, "rates": rates,
            "ref_rates": ref_rates, "trainer": tt}


@pytest.mark.parametrize("epoch", range(CURRICULUM["max_epochs"]))
def test_curriculum_epoch_matches_the_jax_fit(curriculum, epoch):
    ours = curriculum["got"]["history"][epoch]
    theirs = curriculum["ref"]["history"][epoch]
    assert len(curriculum["got"]["history"]) == len(curriculum["ref"]["history"]) == 5
    assert set(ours) == set(theirs)
    want = "pretrain" if epoch < CURRICULUM["pretrain_epochs"] else "finetune"
    assert ours["phase"] == theirs["phase"] == want
    assert ours["steps"] == theirs["steps"] == CURRICULUM["steps_per_epoch"]
    keys = [k for k in EPOCH_KEYS if k in theirs and k not in ("phase", "steps")]
    assert "val_loss" in keys and "train_loss" in keys
    assert ("train_diffusion_loss" in keys) == (want == "pretrain")
    assert ("train_accuracy" in keys) == (want == "finetune")
    for key in keys:
        np.testing.assert_allclose(ours[key], theirs[key], atol=1e-4, rtol=1e-4,
                                   err_msg=f"epoch {epoch} {key}")
    assert curriculum["tlog"].summaries[epoch] == ours


def test_curriculum_rates_match_the_jax_schedule(curriculum):
    """One rate per update, across warmup, the phase switch and the cosine."""
    rates, ref = curriculum["rates"], curriculum["ref_rates"]
    assert len(rates) == STEPS == curriculum["trainer"].step
    np.testing.assert_allclose(rates, ref, atol=1e-7, rtol=0)
    assert rates[0] == 0.0 and max(rates) == pytest.approx(CURRICULUM["learning_rate"])


def test_curriculum_best_val_loss_tracks_both_phases_as_jax(curriculum):
    """The best validation loss is taken over the pretrain epochs' loss
    (diffusion + reconstruction) and the finetune epochs' (cross-entropy)
    alike, as the JAX ``fit`` takes it."""
    got, ref = curriculum["got"], curriculum["ref"]
    assert got["best_val_loss"] == pytest.approx(ref["best_val_loss"], abs=1e-4)
    assert got["best_val_loss"] == min(h["val_loss"] for h in got["history"])


@pytest.mark.parametrize("checkpoint", ["after_pretrain", "end"])
def test_curriculum_parameters_match_the_jax_fit(curriculum, checkpoint):
    epoch = (CURRICULUM["pretrain_epochs"] - 1 if checkpoint == "after_pretrain"
             else CURRICULUM["max_epochs"] - 1)
    got, ref = curriculum["tlog"].params[epoch], curriculum["jlog"].params[epoch]
    steps = (epoch + 1) * CURRICULUM["steps_per_epoch"]
    lr_sum = sum(curriculum["ref_rates"][:steps])
    loose = {k for k in ref if k.endswith(SHIFT_INVARIANT_BIASES)}
    assert loose
    for key in loose:
        err = float((got[key] - ref[key]).abs().max())
        assert err <= lr_sum, f"{key}: {err:.3e} > {lr_sum:.3e}"
    assert_tree_close({k: v for k, v in got.items() if k not in loose},
                      {k: v for k, v in ref.items() if k not in loose}, 1e-4,
                      f"parameters ({checkpoint})")
    first = curriculum["tlog"].params[0]
    moved = max(float((got[k] - first[k]).abs().max()) for k in got if k not in loose)
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# (b) dropout sites and rates
# ---------------------------------------------------------------------------

RATE = 0.2
DROPOUT_CASES = {   # the options that put dropout on different paths
    "plain_and_heads": dict(use_hierarchical=False),            # + regression, survival MLPs
    "hierarchical": dict(num_classes=2, regression_targets=0, survival_mode=None),
    "windowed": dict(use_hierarchical=False, spatial_window=32, graph_window=32, **CLS),
    "moe": dict(use_hierarchical=False, moe_experts=4, **CLS),
    "set2set": dict(use_hierarchical=False, **{**CLS, "pooling": "set2set"}),
}


def keep(shape) -> np.ndarray:
    """The stand-in keep-mask: one element in five dropped, by its flat
    position in ``shape``."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    return ((idx * np.uint64(2654435761)) % np.uint64(2 ** 32) % np.uint64(5) != 0).reshape(shape)


class StandInTorch:
    """``torch`` for ``nn.layers``: ``rand`` returns 1 where ``keep`` keeps
    and 0 where it drops, so ``rand >= rate`` is the stand-in's mask."""

    def __init__(self, shapes):
        self.shapes = shapes

    def __getattr__(self, name):
        return getattr(torch, name)

    def rand(self, shape, generator=None, device=None):
        self.shapes.append(tuple(shape))
        return torch.from_numpy(keep(tuple(shape)).astype(np.float32)).to(device)


def _dropout_batch():
    return _batch((3, 4, 5), (1, 0, 1), (100, 90, 0))   # the last graph a filler


DRAW_RNGS = {"diffusion": 1, "masking": 2, "dropout": 3}


@pytest.fixture(scope="module")
def pretrain_draws():
    """The JAX pretrain step's draws under DRAW_RNGS: they follow from the
    rngs and the shapes (hidden 16, 3 diffusion steps), which every option
    of (b) shares."""
    from dgdm_histopath_torch.nn.layers import init_parameters

    kw = {**KW, "graph_layers": 1, "use_hierarchical": False}
    tm = init_parameters(DGDMModel(**kw), torch.Generator().manual_seed(1))
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                             for k, v in params_to_flax(tm.state_dict(), tm).items()})
    rngs = {k: jax.random.PRNGKey(v) for k, v in DRAW_RNGS.items()}
    with jax.default_matmul_precision("float32"):
        return jax_draws(JaxDGDM(**kw, gather_impl="xla"), params, _dropout_batch(), rngs)


@pytest.fixture(scope="module", params=sorted(DROPOUT_CASES))
def dropout_pair(request, pretrain_draws):
    """One option's JAX training forward, pretrain loss and gradients, and
    the port's, under the stand-in mask; the JAX model takes the port's
    initial parameters."""
    from dgdm_histopath_torch.nn import layers
    from dgdm_histopath_torch.nn.layers import init_parameters

    kw = {**KW, "graph_layers": 1, "dropout": RATE, **DROPOUT_CASES[request.param]}
    batch = _dropout_batch()
    tm = init_parameters(DGDMModel(**kw), torch.Generator().manual_seed(1))
    jm = JaxDGDM(**kw, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(), use_mesh=False)
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                             for k, v in params_to_flax(tm.state_dict(), tm).items()})
    rngs = {k: jax.random.PRNGKey(v) for k, v in DRAW_RNGS.items()}
    jax_shapes, torch_shapes = [], []

    def bernoulli(key, p=0.5, shape=None):
        assert p == pytest.approx(1.0 - RATE)
        jax_shapes.append(tuple(shape))
        return jnp.asarray(keep(tuple(shape)))

    @jax.jit
    def reference(p):
        logits = jm.apply(p, batch, mode="finetune", deterministic=False,
                          rngs=rngs)["classification_logits"]
        (loss, _), grads = jax.value_and_grad(
            lambda q: jt._pretrain_losses(q, batch, rngs), has_aux=True)(p)
        return logits, loss, grads

    original = layers._keep_mask

    def keep_mask(x, rate, generator, rows, node_dim):
        # a pooled level's rows keyed to first-level nodes: the pooled shape
        # (see the module docstring)
        pooled = rows is not None and rows.ids is not None
        return original(x, rate, generator, None if pooled else rows, node_dim)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        mp.setattr(layers, "torch", StandInTorch(torch_shapes))
        mp.setattr(layers, "_keep_mask", keep_mask)
        with jax.default_matmul_precision("float32"):
            logits, loss, grads = jax.device_get(reference(params))
        tbatch = to_torch_graph(batch)
        got_logits = tm(tbatch, mode="finetune", deterministic=False)["classification_logits"]
        n_forward = len(torch_shapes)
        tt = DGDMTrainer(tm, TrainerConfig(), device="cpu")
        got_loss, _ = tt._pretrain_losses(tbatch, pretrain_draws)
        got_loss.backward()
    return {"case": request.param,
            "logits": (got_logits.detach(), torch.from_numpy(np.array(logits))),
            "loss": (float(got_loss.detach()), float(loss)),
            "grads": ({k: p.grad if p.grad is not None else torch.zeros_like(p)
                       for k, p in tm.named_parameters()},
                      params_from_flax(_flat(grads))),
            "jax_shapes": jax_shapes, "torch_shapes": torch_shapes, "n_forward": n_forward}


def test_training_forward_drops_at_the_jax_sites(dropout_pair):
    """Every mask is drawn at the JAX mask's shape, and the logits of a
    training forward agree."""
    got, ref = dropout_pair["logits"]
    n = dropout_pair["n_forward"]
    jax_forward = dropout_pair["jax_shapes"][:n]
    assert n > 0 and dropout_pair["torch_shapes"][:n] == jax_forward
    assert not torch.equal(got, torch.zeros_like(got))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_pretrain_gradients_under_dropout_match_jax(dropout_pair):
    got, ref = dropout_pair["loss"]
    assert got == pytest.approx(ref, abs=1e-5, rel=1e-5)
    # the pretrain step draws the same masks as the JAX step's, in order
    n = dropout_pair["n_forward"]
    pre = dropout_pair["torch_shapes"][n:]
    assert pre and sorted(pre) == sorted(dropout_pair["jax_shapes"][n:n + len(pre)])
    assert_tree_close(*dropout_pair["grads"], 1e-4, f"{dropout_pair['case']} gradient")


# ---------------------------------------------------------------------------
# (c) the harness's per-seed re-entry
# ---------------------------------------------------------------------------

# the tiny c16 run of tests/test_torch_gates.py with both arms (dropout at
# the harness's default 0.1)
TINY_C16 = ["--synthetic", "--hard", "--cpu", "--n-train-per-class", "2",
            "--n-test-per-class", "2", "--slide-size", "256", "--patch-size", "32",
            "--bucket", "64", "--max-patches", "64", "--hidden", "32,16",
            "--pretrain-epochs", "1", "--finetune-epochs", "1", "--batch-size", "2",
            "--extractor", "stats", "--ab-pretrain"]


@pytest.fixture(scope="module")
def reentry(tmp_path_factory):
    """Train seeds 0 and 1 in one process, then seed 1 alone in a fresh
    process on a copy of the first run's slides and graphs."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from dgdm_histopath_torch.scripts import eval_camelyon16

    root = tmp_path_factory.mktemp("reentry")
    both, alone = root / "both", root / "alone"
    eval_camelyon16.main([*TINY_C16, "--out", str(both), "--train-seed", "0,1"])
    alone.mkdir()
    for sub in ("synthetic_data", "graph_cache"):
        shutil.copytree(both / sub, alone / sub)
    repo = Path(__file__).resolve().parent.parent
    # one thread, as this process runs (one_thread): the same sums in the same order
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "dgdm_histopath_torch.scripts.eval_camelyon16",
                           *TINY_C16, "--out", str(alone), "--train-seed", "1"],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return both, alone


@pytest.mark.parametrize("arm", ["dense", "scratch"])
def test_second_seed_in_one_process_equals_it_alone(reentry, arm):
    """Nothing of seed 0's run (optimizer, generators, the loader's epoch,
    the model's train / eval mode after prediction) reaches seed 1's."""
    both, alone = reentry
    name = f"variant_{arm}_s0t1.npz"
    arms = {}
    for key, folder in (("both", both), ("alone", alone)):
        with np.load(folder / name, allow_pickle=True) as z:
            arms[key] = {"probs": z["probs"], "labels": z["labels"],
                         "metrics": json.loads(str(z["metrics"]))}
    a, b = arms["both"], arms["alone"]
    assert np.array_equal(a["labels"], b["labels"])
    assert a["probs"].dtype == b["probs"].dtype and a["probs"].shape == (4,)
    assert np.array_equal(a["probs"], b["probs"]), (a["probs"], b["probs"])
    assert a["metrics"]["best_val_loss"] == b["metrics"]["best_val_loss"]
    assert a["metrics"]["_arm_config"] == b["metrics"]["_arm_config"]
    with np.load(both / f"variant_{arm}_s0.npz", allow_pickle=True) as first:
        assert not np.array_equal(first["probs"], a["probs"])   # the seeds differ
    report = json.loads((alone / "report_t1.json").read_text())
    assert report["graph_cache_misses"] == 0


# ---------------------------------------------------------------------------
# compare_gate_runs: one gate run held to another, seed by seed
# ---------------------------------------------------------------------------

def _write_arms(folder, labels, probs):
    """``probs``: {(tag, train_seed): scores}, written as the harness writes
    its arms (data seed 0)."""
    folder.mkdir(parents=True, exist_ok=True)
    for (tag, s), p in probs.items():
        name = f"variant_{tag}_s0.npz" if s == 0 else f"variant_{tag}_s0t{s}.npz"
        np.savez(folder / name, metrics=json.dumps({"auc": None}), probs=p, labels=labels)


def _arms(seed, n=60, seeds=range(4), dense_signal=1.5, scratch_signal=0.5):
    rs = np.random.RandomState(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    probs = {}
    for s in seeds:
        for tag, signal in (("dense", dense_signal), ("scratch", scratch_signal)):
            probs[(tag, s)] = 1 / (1 + np.exp(-(signal * (2 * labels - 1) + rs.randn(n))))
    return labels, probs


def test_compare_holds_a_run_to_itself(tmp_path, capsys):
    from dgdm_histopath_torch.scripts.compare_gate_runs import main
    labels, probs = _arms(0)
    _write_arms(tmp_path / "a", labels, probs)
    _write_arms(tmp_path / "b", labels, probs)
    out = main(["--ref", str(tmp_path / "a"), "--run", str(tmp_path / "b"), "--cpu"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["train_seeds"] == [0, 1, 2, 3] and out["n_test"] == 60
    assert out["ref_arms"] == out["run_arms"] and not out["fault"]
    for diff in out["differences"].values():
        assert diff["by_seed"] == [0.0] * 4 and diff["ci95"] == [0.0, 0.0]
    side = out["ref_arms"]
    assert side["uplift_mean"] == pytest.approx(side["dense_auc_mean"] - side["scratch_auc_mean"])
    lo, hi = side["dense_auc_ci95_two_level"]
    assert lo < side["dense_auc_mean"] < hi


def test_compare_finds_a_pretraining_that_gives_less(tmp_path):
    """A run whose dense arms learn no more than its scratch arms: the uplift
    differences' CI lies below zero, a fault by the rule."""
    from dgdm_histopath_torch.scripts.compare_gate_runs import compare
    labels, probs = _arms(1)
    _write_arms(tmp_path / "ref", labels, probs)
    _, weak = _arms(2, dense_signal=0.5)
    _write_arms(tmp_path / "run", labels, weak)
    out = compare(tmp_path / "ref", tmp_path / "run", n_bootstrap=500)
    uplift = out["differences"]["uplift"]
    assert uplift["ci95"][1] < 0 and uplift["ci_excludes_zero"] and out["fault"]
    assert out["differences"]["dense_auc"]["mean"] < 0


@pytest.mark.parametrize("fault", ["other_labels", "one_seed", "missing_arm"])
def test_compare_refuses_runs_it_cannot_pair(tmp_path, fault):
    from dgdm_histopath_torch.scripts.compare_gate_runs import compare
    labels, probs = _arms(3)
    _write_arms(tmp_path / "ref", labels, probs)
    run_labels, run_probs = labels, dict(probs)
    if fault == "other_labels":
        run_labels = labels[::-1].copy()
    elif fault == "one_seed":
        run_probs = {k: v for k, v in probs.items() if k[1] == 0}
    else:
        del run_probs[("scratch", 2)]
    _write_arms(tmp_path / "run", run_labels, run_probs)
    with pytest.raises(SystemExit, match="test labels differ|two seeds or more"):
        compare(tmp_path / "ref", tmp_path / "run",
                seeds=[0, 1, 2] if fault == "missing_arm" else None, n_bootstrap=50)


def test_compare_reads_the_committed_arms_as_the_aggregator():
    """On the committed c16 arms (the JAX package's, seeds 0-9): the per-seed
    uplifts and the arms' means of ``report_pooled.json``. (Its CIs come
    from the same ``pooled_paired_bootstrap_delta``; a few draws keep this
    short.) Without a card and without ``--cpu`` the entry point stops
    before it reads an arm."""
    from pathlib import Path

    from dgdm_histopath_torch.scripts.compare_gate_runs import compare, main
    c16 = Path(__file__).resolve().parent.parent / "docs" / "results" / "c16_hard"
    pooled = json.loads((c16 / "report_pooled.json").read_text())
    with pytest.raises(SystemExit) as exc:
        main(["--ref", str(c16), "--run", str(c16)])
    assert exc.value.code == 2
    out = compare(c16, c16, n_bootstrap=20)
    side = out["ref_arms"]
    assert out["train_seeds"] == list(range(10)) and not out["fault"]
    assert [round(v, 4) for v in side["uplift_by_seed"]] == \
        pooled["pretrain_auc_uplift"]["per_seed"]
    assert round(side["dense_auc_mean"], 4) == pooled["arms"]["dense"]["auc_mean"]
    assert round(side["scratch_auc_mean"], 4) == pooled["arms"]["scratch"]["auc_mean"]
