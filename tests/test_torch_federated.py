"""The port's federated learning against the JAX package's, on the CPU.

``FederatedServer`` under the four strategies (and ``clients_per_round``)
over the same toy trees and the same deterministic local updates in both
packages for 3 rounds: parameters and ``update_norm`` within 1e-6, the
clients called in the same order. ``DPConfig``'s clipping equals JAX's
within 1e-6; its noise is checked by statistics (the two frameworks cannot
share random numbers). ``FederatedDGDMManager`` at a tiny width with the
JAX parameters converted into the port, finetune phase, dropout 0: the
global parameters after each round within 1e-5 of JAX's, the
shift-invariant biases (true gradient zero: Adam turns rounding noise into
lr-sized steps) within the summed learning rates, as the training tests
hold them. The port sums the aggregate in f64: its new global parameters
are the f64 weighted mean of the updates applied once and rounded once.

The JAX manager hands the server's global parameters to a trainer whose
step donates its state, so its second client reads deleted buffers
(ROADMAP queue 3); the JAX side here runs with a trainer that copies its
parameters before each step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgdm_histopath_torch.quantum as tquantum
import dgdm_histopath_tpu.quantum as jquantum
from conftest import make_synthetic_graph
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.quantum import federated_learning as tf
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.quantum import federated_learning as jf
from dgdm_histopath_tpu.training import trainer as jtr
from test_torch_model import _flat
from test_torch_training import SHIFT_INVARIANT_BIASES, to_torch_graph


def test_quantum_exports_the_federated_names():
    assert {"FederatedClient", "FederatedServer", "FederatedStrategy", "FederatedDGDMManager",
            "DPConfig"} <= set(tquantum.__all__)
    assert sorted(tquantum.__all__) == sorted(jquantum.__all__)


def _toy():
    rs = np.random.RandomState(0)
    return {"w": rs.randn(4, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}


# deterministic local updates: a pull towards a client target, a scaling, a shift
UPDATES = [lambda p, r: p + 0.1 * (r + 1), lambda p, r: p * 0.9 - 0.05,
           lambda p, r: 0.5 * p + 0.2, lambda p, r: p - 0.3]
SAMPLES = [100, 50, 30, 7]


def _run_server(fed, to_tree, from_tree, strategy, clients_per_round=None, dp=None, rounds=3):
    calls = []

    def local(i):
        def fn(params, r):
            calls.append(i)
            return {k: UPDATES[i](v, r) for k, v in params.items()}
        return fn
    server = fed.FederatedServer(to_tree(_toy()), strategy=strategy,
                                 clients_per_round=clients_per_round, fedprox_mu=0.1,
                                 server_lr=0.8, seed=3)
    for i in range(len(UPDATES)):
        server.register_client(fed.FederatedClient(f"c{i}", local(i), SAMPLES[i], dp=dp))
    params, norms = [], []
    for r in range(rounds):
        norms.append(server.run_round(r)["update_norm"])
        params.append(from_tree(server.global_params))
    return params, norms, calls


def _j_tree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _t_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t_np(tree):
    return {k: v.numpy() for k, v in tree.items()}


@pytest.mark.parametrize("strategy", ["fedavg", "fedprox", "scaffold", "quantum_fed"])
@pytest.mark.parametrize("per_round", [None, 2])
def test_server_rounds_match_jax(strategy, per_round):
    got = _run_server(tf, _t_tree, _t_np, strategy, per_round)
    ref = _run_server(jf, _j_tree, _np, strategy, per_round)
    assert got[2] == ref[2]                                  # the same clients, in order
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-6)
    for g, r in zip(got[0], ref[0]):
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_dp_clipping_matches_jax_and_the_noise_has_its_sigma():
    big = {"w": np.full((300, 400), 0.5, np.float32), "b": np.arange(50, dtype=np.float32)}
    dp = dict(clip_norm=2.0, noise_multiplier=0.0)
    got = tf.DPConfig(**dp).privatize(_t_tree(big), torch.Generator().manual_seed(0))
    ref = jf.DPConfig(**dp).privatize(_j_tree(big), jax.random.PRNGKey(0))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    assert float(tf.tree_global_norm(got)) <= 2.0 * (1 + 1e-6)
    small = {"w": np.full((2, 2), 1e-3, np.float32)}       # under the clip: unchanged
    assert torch.equal(tf.DPConfig(1.0).privatize(_t_tree(small), None)["w"],
                       _t_tree(small)["w"])
    # noise: sigma = 0.05 * 2, one normal a leaf from the generator
    noisy = tf.DPConfig(clip_norm=2.0, noise_multiplier=0.05)
    a = noisy.privatize(_t_tree(big), torch.Generator().manual_seed(1))
    b = noisy.privatize(_t_tree(big), torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    resid = torch.cat([(a[k] - got[k]).flatten() for k in a]).double()
    assert abs(float(resid.std()) / 0.1 - 1) < 0.02 and abs(float(resid.mean())) < 1e-3


KW = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3, attention_heads=4,
          graph_layers=2, num_classes=2, compute_dtype="float32", dropout=0.0,
          use_hierarchical=False)
CFG = dict(learning_rate=1e-3, warmup_steps=0, pretrain_epochs=0, max_epochs=2)
ROUNDS, LOCAL = 2, 2


class _CopyingTrainer(jtr.DGDMTrainer):
    """The JAX trainer, its parameters copied before each donating step."""

    def training_step(self, batch, epoch=None, **kw):
        self.state = self.state.replace(
            params=jax.tree_util.tree_map(jnp.copy, self.state.params))
        return super().training_step(batch, epoch, **kw)


def _loaders():
    def batch(seed0):
        graphs = [make_synthetic_graph(seed=seed0 + i, n_nodes=32, n_real=28, feat_dim=16)
                  for i in range(2)]
        return j_batch(graphs).replace(y=jnp.asarray([0, 1], jnp.int32))
    return {"a": [batch(0), batch(2)], "b": [batch(10)]}


@pytest.fixture(scope="module")
def managers():
    """The JAX manager's global parameters after each round and the port's
    manager (2 clients, 2 local steps, 2 FedAvg rounds), its parameters
    converted from the JAX trainer's initial state."""
    loaders = _loaders()
    jm = JaxDGDM(**KW, gather_impl="xla")
    with jax.default_matmul_precision("float32"):
        def j_factory():
            t = _CopyingTrainer(jm, jtr.TrainerConfig(**CFG), use_mesh=False)
            t.init_state(jax.random.PRNGKey(11), loaders["a"][0])
            return t
        jman = jf.FederatedDGDMManager(j_factory, loaders, local_steps=LOCAL)
        params0 = jax.device_get(jman.global_params)
        ref = []
        for _ in range(ROUNDS):
            jman.server.run_round(len(ref))
            ref.append(params_from_flax(_flat(jax.device_get(jman.global_params))))

    def t_factory():
        model = DGDMModel(**KW)
        load_state(model, params_from_flax(_flat(params0)))
        t = DGDMTrainer(model, TrainerConfig(**CFG), device="cpu")
        t.init_state(seed=0)
        return t
    t_loaders = {k: [to_torch_graph(b) for b in v] for k, v in loaders.items()}
    tman = tf.FederatedDGDMManager(t_factory, t_loaders, local_steps=LOCAL)
    return ref, jman, tman


def test_manager_rounds_match_the_jax_manager(managers):
    ref, jman, tman = managers
    lr_sum = sum(tman.trainers["a"].lr_schedule(s) for s in range(ROUNDS * LOCAL))
    before = {k: v.clone() for k, v in tman.global_params.items()}
    for r in range(ROUNDS):
        tman.server.run_round(r)
        got = tman.global_params
        assert set(got) == set(ref[r])
        for key, want in ref[r].items():
            atol = lr_sum if key.endswith(SHIFT_INVARIANT_BIASES) else 1e-5
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), atol=atol, rtol=0,
                                       err_msg=f"round {r} {key}")
    assert max(float((tman.global_params[k] - v).abs().max()) for k, v in before.items()) > 1e-4
    assert [c.client_id for c in tman.server.clients] == ["a", "b"]
    assert [t.step for t in tman.trainers.values()] == [ROUNDS * LOCAL] * 2
    assert [h["clients"] for h in tman.server.history] == [h["clients"]
                                                            for h in jman.server.history]


def test_manager_clones_the_global_parameters_and_aggregates_in_f64(managers):
    """The global dict is a copy: client 0's in-place steps do not move it,
    and the new global is the f64 weighted mean of the updates, applied to
    the old parameters and rounded once."""
    _, _, tman = managers
    old = {k: v.clone() for k, v in tman.global_params.items()}
    tman.server.run_round(ROUNDS)
    live_model = tman.trainers["a"].model
    live = dict(live_model.named_parameters())
    weights = {"a": 2 / 3, "b": 1 / 3}                  # 2 and 1 batches
    for k, p in old.items():
        upd = {c: (dict(t.model.named_parameters())[k].detach() - p).double()
               for c, t in tman.trainers.items()}
        want = (p.double() + sum(w * upd[c] for c, w in weights.items())).float()
        assert torch.equal(tman.global_params[k], want), k
        assert tman.global_params[k].data_ptr() != live[k].data_ptr()
    assert any(not torch.equal(live[k], old[k]) for k in old)
    with pytest.raises(ValueError, match="initialized"):
        tf.FederatedDGDMManager(lambda: DGDMTrainer(copy.deepcopy(live_model), TrainerConfig(**CFG),
                                                    device="cpu"), {"a": []})
