"""``DGDMTrainer.fit`` with its checkpoint manager, train logger, preemption
guard and mid-epoch resume, on the CPU.

A run stopped by the guard and resumed from its emergency checkpoint ends
with parameters, AdamW state and step equal to the bit to the run that was
not stopped (dropout 0.1: the draws come from ``(seed, step)``).
Finetune-only ``fit`` at dropout 0 from the JAX trainer's initial weights
against the JAX ``fit``: every epoch's train and validation losses and
accuracies within 1e-4 (the JAX side at float32 matmul precision).
"""

import jax
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.nn.layers import init_parameters
from dgdm_histopath_torch.training import (
    CheckpointManager,
    DGDMTrainer,
    PreemptionGuard,
    TrainLogger,
    TrainerConfig,
)
from test_torch_model import KW
from test_torch_training import make_batch, to_torch_graph, torch_model
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_torch.models.dgdm import DGDMModel

Y = np.array([1, 0, 1], np.int32)
CFG = dict(learning_rate=1e-3, warmup_steps=1, pretrain_epochs=1, max_epochs=3)


def _batches():
    """Three labelled host batches (the last graph of each a filler)."""
    base = make_batch(Y)
    out = []
    for shift in range(3):
        b = to_torch_graph(base)
        out.append(b.replace(x=b.x * (1.0 + 0.1 * shift)))
    return out


def _trainer(dropout=0.1):
    model = init_parameters(DGDMModel(**{**KW, "dropout": dropout}),
                            torch.Generator().manual_seed(5))
    trainer = DGDMTrainer(model, TrainerConfig(**CFG), device="cpu")
    trainer.init_state(seed=9)
    return trainer


def _assert_same_state(a: DGDMTrainer, b: DGDMTrainer):
    assert a.step == b.step and a.seed == b.seed
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for key, value in st.items():
            assert torch.equal(value, sb["state"][i][key]), (i, key)


@pytest.mark.parametrize("stop_after", [1, 3, 4])
def test_preempted_and_resumed_fit_is_bit_equal(tmp_path, stop_after):
    """``stop_after`` steps: inside epoch 0, at its last step, inside epoch 1."""
    batches = _batches()
    ref = _trainer()
    ref.fit(batches, val_loader=batches[:1])

    class StopAfter(PreemptionGuard):
        def __init__(self, n, trainer):
            super().__init__(install=False)
            self.n, self.trainer = n, trainer

        @property
        def triggered(self):
            return self.trainer.step >= self.n

    stopped = _trainer()
    mgr = CheckpointManager(tmp_path, save_top_k=5)
    result = stopped.fit(batches, val_loader=batches[:1], checkpoint_manager=mgr,
                         preemption_guard=StopAfter(stop_after, stopped))
    position = result["resume"]
    assert result["interrupted"] and position["mid_epoch"]
    epoch, before = divmod(stop_after - 1, 3)
    assert (position["epoch"], position["step_in_epoch"]) == (epoch, before + 1)
    assert CheckpointManager(tmp_path).record_extra() == {"resume": position}

    resumed = _trainer()
    resumed.load_state_dict(mgr.restore())
    assert resumed.step == stop_after
    resumed.current_epoch = position["epoch"]
    out = resumed.fit(batches, val_loader=batches[:1], checkpoint_manager=mgr,
                      start_step_in_epoch=position["step_in_epoch"])
    assert not out["interrupted"]
    _assert_same_state(resumed, ref)
    strip = ("epoch_time_s", "train_loss", "train_accuracy", "train_grad_norm",
             "train_diffusion_loss", "train_reconstruction_loss", "train_contrastive_loss")
    assert [{k: v for k, v in h.items() if k not in strip} for h in out["history"]] == [
        {k: v for k, v in h.items() if k not in strip} for h in ref.history[position["epoch"]:]]
    assert out["history"][-1] == {**ref.history[-1], "epoch_time_s":
                                  out["history"][-1]["epoch_time_s"]}


def test_fit_checkpoints_every_validated_epoch_and_logs_its_summary(tmp_path):
    batches = _batches()
    trainer = _trainer()
    mgr = CheckpointManager(tmp_path / "ckpt", save_top_k=2)
    logger = TrainLogger(tmp_path / "logs", logger_type="csv")
    result = trainer.fit(batches, val_loader=batches[:2], checkpoint_manager=mgr,
                         train_logger=logger)
    logger.close()
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["pretrain", "finetune", "finetune"]
    assert len(mgr.all_steps()) == 2 and mgr.last_step == 2
    best = min(range(3), key=lambda e: hist[e]["val_loss"])
    assert mgr.best_step == best and result["best_val_loss"] == hist[best]["val_loss"]
    state = mgr.restore()
    assert state["step"] == 9 and state["current_epoch"] == 2 and state["seed"] == 9
    import json
    rows = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert [r["val_loss"] for r in rows] == [h["val_loss"] for h in hist]


def test_state_dict_moves_a_run_to_another_trainer():
    batches = _batches()
    a = _trainer()
    a.fit(batches[:2], max_epochs=1)
    b = _trainer()
    b.load_state_dict(a.state_dict())
    _assert_same_state(a, b)
    assert b.current_epoch == a.current_epoch == 0
    assert a.training_step(batches[2], 1) == b.training_step(batches[2], 1)
    with pytest.raises(RuntimeError, match="init_state"):
        DGDMTrainer(DGDMModel(**KW), device="cpu").state_dict()


def test_finetune_only_fit_matches_the_jax_fit():
    cfg = dict(learning_rate=1e-3, warmup_steps=1, pretrain_epochs=0, max_epochs=3,
               steps_per_epoch=2)
    base = make_batch(Y)
    jbatches = [base, base.replace(x=base.x * 1.1)]
    jm = JaxDGDM(**KW, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**cfg), use_mesh=False)
    with jax.default_matmul_precision("float32"):
        state = jt.init_state(jax.random.PRNGKey(4), base)
        tm = torch_model(jax.device_get(state.params))
        ref = jt.fit(jbatches, val_loader=jbatches[:1])
    tt = DGDMTrainer(tm, TrainerConfig(**cfg), device="cpu")
    tt.init_state(seed=0)
    got = tt.fit([to_torch_graph(b) for b in jbatches], val_loader=[to_torch_graph(base)])
    assert len(got["history"]) == len(ref["history"]) == 3
    for ours, theirs in zip(got["history"], ref["history"]):
        assert ours["phase"] == theirs["phase"] == "finetune"
        for key in ("train_loss", "train_accuracy", "val_loss", "val_accuracy"):
            np.testing.assert_allclose(ours[key], theirs[key], atol=1e-4, rtol=1e-4,
                                       err_msg=f"epoch {ours['epoch']} {key}")
    assert got["best_val_loss"] == pytest.approx(ref["best_val_loss"], abs=1e-4)
