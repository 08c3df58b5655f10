"""The parallel tiers of the port on the CPU: tensor parallelism through the
trainer, expert parallelism, node sharding with the halo exchange, the GPipe
encoder and the multichip dry run.

One spawn of 4 gloo ranks (``torch_dp_worker.spawn_ranks``, jobs in
``torch_parallel_worker``) runs every multi-rank scenario; the JAX
references and the one-process runs are computed once here, the JAX side
at float32 matmul precision on the 8 virtual CPU devices of conftest.py.
Bounds: tensor-parallel steps against one port process as
tests/test_torch_dp.py holds data parallelism (metrics 1e-5 of
max(1, |x|), parameters 1e-5, the
shift-invariant key biases to the steps' summed learning rate) and against
the JAX trainer on one device as the JAX test does (loss rel 2e-4,
parameters atol 2e-4); ``halo_gather`` equal to the bit to JAX's;
``sp_graph_conv`` 1e-5; ``sp_forward`` (the model over node-sharded
inputs, with the attention and the Set2Set readout) 1e-4 of JAX ``DGDMModel.apply`` (the JAX test's bound,
tests/test_spmd.py::TestNodeSharding) and 1e-5 of the port's one-process
forward, every pooled level's selection equal; the pipeline's outputs and
gradients 1e-4; the expert-parallel block 2e-5 with routing equal. The
layouts are held leaf for leaf against ``tp_param_specs`` /
``ep_param_specs`` on the JAX tree.

Training over node-sharded inputs (``DGDMTrainer.training_step(block,
epoch, prepared=True, plan=plan)``, 3 pretrain and 1 finetune steps of a
2-layer tiny Base with the U-Net and the spatial attention): with dropout
0.1 at (1, 2) against one port process and at (2, 2) against the
data-parallel (2, 1) run (each data rank keeps a dropout stream of its own,
as data parallelism does), the data-parallel bounds above; with the JAX
draws and no dropout at (1, 2) and (2, 2) against one port process and
against JAX ``training_step(shard_graph_nodes(batch, mesh), prepared=True)``
on a (2, 2) mesh of virtual devices (loss rel 2e-4, parameters atol 2e-4).
That JAX run compiles while the ranks work, in a thread beside the spawn.
The gradients through ``halo_gather`` and ``sp_graph_conv``, summed over
the ranks, 1e-5 of ``jax.grad`` of the JAX functions.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.models import DGDMModel as JaxDGDM
from dgdm_histopath_tpu.models.encoders import GraphEncoder as JaxGraphEncoder
from dgdm_histopath_tpu.nn.graph_layers import GraphConvolution as JaxGraphConvolution
from dgdm_histopath_tpu.ops.graph import batch_graphs as j_batch
from dgdm_histopath_tpu.parallel import ep as jep
from dgdm_histopath_tpu.parallel import halo as jhalo
from dgdm_histopath_tpu.parallel import tp as jtp
from dgdm_histopath_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dgdm_histopath_tpu.parallel.pp import pp_graph_encoder_apply as jax_pp_apply
from dgdm_histopath_tpu.parallel.sp import shard_graph_nodes as jax_shard_nodes
from dgdm_histopath_tpu.training import trainer as jtr
from dgdm_histopath_torch.convert import params_from_flax, params_to_flax
from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.models.encoders import GraphEncoder
from dgdm_histopath_torch.nn.graph_layers import GraphConvolution
from dgdm_histopath_torch.nn.layers import DenseGeneral, init_parameters
from dgdm_histopath_torch.nn.moe import MoEFFN
from dgdm_histopath_torch.parallel import (constrain_nodes, dryrun_multichip, halo,
                                           level_sizes, make_pp_layers_fn, node_sharding,
                                           pp_bubble_fraction, shard_graph_nodes,
                                           shard_tree_like, sp_forward, stack_layer_params,
                                           unstack_layer_params)
from dgdm_histopath_torch.parallel.ep import count_expert_sharded, ep_param_specs
from dgdm_histopath_torch.parallel.mesh import Axis, Mesh
from dgdm_histopath_torch.parallel.tp import (describe_sharding, flatten_specs, nest,
                                              tp_param_specs)
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from test_torch_dp import CFG, MODEL, assert_params_close, jax_batch, single_run
from test_torch_model import _flat
from test_torch_training import jax_draws, to_torch_graph
from torch_dp_worker import spawn_ranks

WORKER = "torch_parallel_worker"
# the JAX test's tensor-parallel configuration (tests/test_spmd.py::setup_trainer)
SPMD_MODEL = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3,
                  attention_heads=4, graph_layers=1, num_classes=2, regression_targets=0,
                  survival_mode=None, use_hierarchical=False, use_spatial_attention=False,
                  compute_dtype="float32", dropout=0.0)
SPMD_CFG = dict(learning_rate=1e-3, warmup_steps=1, pretrain_epochs=0, steps_per_epoch=10,
                scheduler_type="none")
PRETRAIN_EPOCHS = [0, 0, 1]
MOE = dict(features=32, hidden_dim=64, num_experts=4, group_size=64, dtype=torch.float32)
MOE_CASES = {"top1": dict(top_k=1, capacity_factor=1.5), "top2_drops": dict(top_k=2,
                                                                           capacity_factor=0.5)}
PP_HID, PP_HEADS, PP_LAYERS = 32, 4, 4
# a tiny DGDM-Base: 4 graph layers, spatial attention, the depth-2 U-Net,
# attention pooling, edge features, every head, f32
SP_MODEL = {**MODEL, "graph_layers": 4, "regression_targets": 1, "survival_mode": "discrete",
            "survival_intervals": 4}
SP_BUCKETS, SP_SHAPES, SP_GRAPHS = (32, 64), ((1, 4), (2, 2)), 4
# the same with the Set2Set readout, on the 32 bucket
SP_SET2SET = {**SP_MODEL, "pooling": "set2set"}
# node-sharded training: the tiny Base with 2 graph layers on the 32 bucket
SP_TRAIN = {**SP_MODEL, "graph_layers": 2}
SP_TRAIN_EPOCHS = [0, 0, 0, 1]
SP_TRAIN_Y = np.array([2, 0, 1, 1], np.int32)


def spmd_batch():
    gs = [make_synthetic_graph(seed=i, n_nodes=24, n_real=20, feat_dim=16)
          .replace(y=jnp.asarray(i % 2, jnp.int32)) for i in range(4)]
    return j_batch(gs)


def sorted_batch():
    gs = [jhalo.spatial_sort(make_synthetic_graph(seed=i, n_nodes=64, n_real=56, feat_dim=16))
          for i in range(4)]
    return j_batch(gs)


def jax_tp_reference(ref):
    """The JAX trainer on one device, three finetune steps (the JAX test)."""
    jbatch = spmd_batch()
    jm = JaxDGDM(**SPMD_MODEL, gather_impl="xla")
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**SPMD_CFG), mesh=None, use_mesh=False)
    state = jt.init_state(jax.random.PRNGKey(0), jbatch)
    ref["spmd_state0"] = params_from_flax(_flat(jax.device_get(state.params)))
    ref["spmd_jax"] = [jt.training_step(jbatch, epoch=1) for _ in range(3)]
    ref["spmd_jax_params"] = params_from_flax(_flat(jax.device_get(jt.state.params)))
    ref["spmd_batch"] = to_torch_graph(jbatch)


def jax_layouts(ref):
    """The JAX spec trees of the full model and of the MoE model (shapes
    only: ``jax.eval_shape`` of ``init``)."""
    batch = jax_batch(2, np.zeros(2, np.int32))
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    for name, kw in (("full", MODEL), ("moe", {**MODEL, "moe_experts": 4})):
        shapes = jax.eval_shape(lambda: JaxDGDM(**kw, gather_impl="xla").init(
            rngs, batch, mode="pretrain", deterministic=True))
        jmesh = jax_make_mesh(axes=("data", "model"), shape=(2, 4))
        specs = jtp.tp_param_specs(shapes, jmesh)
        ref[f"tp_specs_{name}"] = {p: tuple(s) for p, s in _flat_specs(specs).items()}
        ref[f"tp_counts_{name}"] = jtp.describe_sharding(shapes, jmesh)
        if name == "moe":
            emesh = jax_make_mesh(axes=("data", "expert"), shape=(2, 4))
            especs = jep.ep_param_specs(shapes, emesh)
            ref["ep_specs"] = {p: tuple(s) for p, s in _flat_specs(especs).items()}
            ref["ep_count"] = jep.count_expert_sharded(especs)


def _flat_specs(specs):
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): v for kp, v in leaves}


def jax_halo_reference(ref):
    batch = sorted_batch()
    plan = jhalo.build_halo_plan(batch.nbr_idx, batch.nbr_mask, tp=4)
    jmesh = jax_make_mesh(axes=("data", "model"), shape=(2, 4))
    ref["halo_batch"], ref["halo_plan"] = batch, plan
    ref["halo_gather"] = np.asarray(jhalo.halo_gather(batch.x, plan, jmesh))
    g = jhalo.spatial_sort(make_synthetic_graph(seed=5, n_nodes=64, n_real=56, feat_dim=8))
    plan1 = jhalo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=4)
    ref["one"], ref["one_plan"] = g, plan1
    ref["one_gather"] = np.asarray(jhalo.halo_gather(g.x, plan1, jmesh, batch_sharded=False))
    layer = JaxGraphConvolution(features=24, gather_impl="xla", dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), batch.x, batch.nbr_idx, batch.nbr_mask,
                        batch.edge_attr)
    sharded = jax_shard_nodes(batch, jmesh)
    ref["sp"] = np.asarray(jhalo.sp_graph_conv(params["params"], sharded.x, sharded.nbr_idx,
                                               sharded.nbr_mask, plan, jmesh,
                                               edge_attr=sharded.edge_attr))
    ref["conv_state"] = params_from_flax(_flat(params))

    # jax.grad through both, of sum(out * cotangent) (real nodes for the conv)
    rs = np.random.RandomState(7)
    gcot = rs.randn(*ref["halo_gather"].shape).astype(np.float32)
    ccot = (rs.randn(*ref["sp"].shape) * np.asarray(batch.node_mask)[..., None]
            ).astype(np.float32)
    gx = jax.grad(lambda x: jnp.sum(jhalo.halo_gather(x, plan, jmesh) * gcot))(batch.x)

    def conv_loss(p, x):
        out = jhalo.sp_graph_conv(p, x, sharded.nbr_idx, sharded.nbr_mask, plan, jmesh,
                                  edge_attr=sharded.edge_attr)
        return jnp.sum(out * ccot)

    gp, cx = jax.grad(conv_loss, argnums=(0, 1))(params["params"], sharded.x)
    ref["halo_grads"] = {"gather_cot": torch.from_numpy(gcot), "conv_cot": torch.from_numpy(ccot),
                         "gather_dx": np.asarray(gx), "conv_dx": np.asarray(cx),
                         "conv_grads": params_from_flax(_flat({"params": jax.device_get(gp)}))}


def sp_train_batch():
    return sp_batch(32).replace(y=jnp.asarray(SP_TRAIN_Y))


def jax_sp_train_init(ref):
    """The JAX trainer of the node-sharded steps on a (2, 2) (data, model)
    mesh: its initial parameters (the port's too) and the draws of its
    pretrain steps, read back as tests/test_torch_dp.py reads them."""
    batch = sp_train_batch()
    jm = JaxDGDM(**SP_TRAIN, gather_impl="xla")
    jmesh = jax_make_mesh(n_devices=4, axes=("data", "model"), shape=(2, 2))
    jt = jtr.DGDMTrainer(jm, jtr.TrainerConfig(**CFG), mesh=jmesh)
    state = jt.init_state(jax.random.PRNGKey(11), batch)
    params0 = jax.device_get(state.params)
    rng0 = jnp.asarray(np.array(state.rng))
    draws = []
    for step, epoch in enumerate(SP_TRAIN_EPOCHS):
        rng = jax.random.fold_in(rng0, step)
        rngs = {"diffusion": jax.random.fold_in(rng, 0), "masking": jax.random.fold_in(rng, 1),
                "dropout": jax.random.fold_in(rng, 2)}
        draws.append(jax_draws(jm, params0, batch, rngs) if epoch == 0 else None)
    ref["sp_train"] = {"trainer": jt, "block": jax_shard_nodes(batch, jmesh),
                       "state0": params_from_flax(_flat(params0)), "draws": draws,
                       "batch": to_torch_graph(batch)}


def jax_sp_train_steps(ref):
    """JAX ``training_step(shard_graph_nodes(batch, mesh), prepared=True)``."""
    r = ref["sp_train"]
    jt, block = r.pop("trainer"), r.pop("block")
    r["jax"] = [jt.training_step(block, e, prepared=True) for e in SP_TRAIN_EPOCHS]
    r["jax_params"] = params_from_flax(_flat(jax.device_get(jt.state.params)))


def sp_batch(n):
    """Morton-sorted graphs of bucket n with 4-7 padding nodes each."""
    return j_batch([jhalo.spatial_sort(make_synthetic_graph(seed=20 + i, n_nodes=n,
                                                            n_real=n - 4 - i, feat_dim=16))
                    for i in range(SP_GRAPHS)])


def jax_sp_reference(ref, prefix="sp", model=SP_MODEL, buckets=SP_BUCKETS):
    """JAX ``DGDMModel.apply`` (inference) of the tiny Base on each bucket,
    one parameter tree."""
    jm = JaxDGDM(**model, gather_impl="xla")
    batches = {n: sp_batch(n) for n in buckets}
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    params = jm.init(rngs, batches[32], mode="pretrain", deterministic=True)
    fwd = jax.jit(lambda p, g: jm.apply(p, g, mode="inference", deterministic=True))
    ref[f"{prefix}_state"] = params_from_flax(_flat(params))
    ref[f"{prefix}_forward"] = {n: {k: np.asarray(v) for k, v in fwd(params, b).items()
                                    if k in ("classification_logits", "graph_embedding")}
                                for n, b in batches.items()}
    ref[f"{prefix}_batches"] = {n: to_torch_graph(b) for n, b in batches.items()}


def sp_one_process(state, batches, model=SP_MODEL):
    """The port's one-process forward of each batch, with every pooled
    level's selection."""
    model = DGDMModel(**model)
    model.load_state_dict(state)
    sel = {}
    for d in range(2):
        getattr(model.graph_unet, f"pool{d}").register_forward_hook(
            lambda m, i, o, d=d: sel.__setitem__(d, o["sel_idx"]))
    out = {}
    with torch.no_grad():
        for n, b in batches.items():
            out[n] = model(b)
            out[n]["pool_sel_idx"] = [sel[0], sel[1]]
    return out


def pp_batch():
    return j_batch([make_synthetic_graph(seed=i, n_nodes=32, n_real=28, feat_dim=16)
                    for i in range(4)])


def jax_pp_reference(ref):
    """JAX ``pp_graph_encoder_apply`` on a 4-stage pipe: forward of each
    variant, gradients of ``sum(out ** 2)`` with edges."""
    g = pp_batch()
    pmesh = jax_make_mesh(n_devices=4, axes=("pipe",))
    ref["pp"] = {}
    for name, band, edges in (("edges", None, True), ("no_edges", None, False),
                              ("banded", 8, True)):
        enc = JaxGraphEncoder(hidden_dim=PP_HID, num_layers=PP_LAYERS, num_heads=PP_HEADS,
                              dropout=0.0, gather_impl="xla", band_window=band,
                              dtype=jnp.float32, param_dtype=jnp.float32)
        params = enc.init(jax.random.PRNGKey(0), g.x, g.nbr_idx, g.nbr_mask, g.node_mask,
                          edge_attr=g.edge_attr, deterministic=True)["params"]
        ea = g.edge_attr if edges else None
        use = params if edges else {k: v for k, v in params.items() if k != "edge_proj"}

        def loss(p, enc=enc, ea=ea):
            out = jax_pp_apply(enc, p, pmesh, g.x, g.nbr_idx, g.nbr_mask, g.node_mask,
                               edge_attr=ea, num_micro=2)
            return jnp.sum(out ** 2), out

        if name == "edges":
            (_, out), grads = jax.value_and_grad(loss, has_aux=True)(use)
            ref["pp_jax_grads"] = params_from_flax(_flat({"params": jax.device_get(grads)}))
        else:
            out = loss(use)[1]
        ref["pp"][name] = {"state": params_from_flax(_flat({"params": params})),
                           "band": band, "edges": edges, "out": np.asarray(out)}
    ref["pp_graph"] = to_torch_graph(g)


def port_encoder(band, state):
    enc = GraphEncoder(16, PP_HID, PP_LAYERS, PP_HEADS, edge_dim=3, band_window=band)
    enc.load_state_dict(state)
    return enc


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    """The JAX references, one spawn of 4 ranks for every scenario, and the
    one-process runs of the port."""
    tmp = tmp_path_factory.mktemp("parallel")
    ref = {}
    with jax.default_matmul_precision("float32"):
        jax_tp_reference(ref)
        jax_layouts(ref)
        jax_halo_reference(ref)
        jax_sp_reference(ref)
        jax_sp_reference(ref, "s2s", SP_SET2SET, (32,))
        jax_pp_reference(ref)
        jax_sp_train_init(ref)

    # the port's full model for the pretrain scenarios: seeded parameters
    model0 = init_parameters(DGDMModel(**MODEL), torch.Generator().manual_seed(3))
    state0 = {k: v.detach().clone() for k, v in model0.state_dict().items()}
    t4 = to_torch_graph(jax_batch(4, np.array([2, 0, 1, 1], np.int32)))
    pre_steps = [(t4, e, None) for e in PRETRAIN_EPOCHS]
    spmd_steps = [(ref["spmd_batch"], 1, None)] * 3

    rs = np.random.RandomState(0)
    moe_x = torch.from_numpy(rs.randn(4, 32, 32).astype(np.float32))
    moe_mask = torch.ones(4, 32, dtype=torch.bool)
    moe_mask[1, 20:] = False
    moe_states = {}
    for case, kw in MOE_CASES.items():
        m = init_parameters(MoEFFN(**MOE, **kw), torch.Generator().manual_seed(4))
        moe_states[case] = m.state_dict()

    hb = ref["halo_batch"]
    port_halo_batch = to_torch_graph(hb)
    plan = halo.build_halo_plan(port_halo_batch.nbr_idx, port_halo_batch.nbr_mask, tp=4)
    one = to_torch_graph(ref["one"])
    one_plan = halo.build_halo_plan(one.nbr_idx, one.nbr_mask, tp=4)
    pp_variants = {name: {"encoder": dict(in_features=16, hidden_dim=PP_HID,
                                          num_layers=PP_LAYERS, num_heads=PP_HEADS,
                                          edge_dim=3, band_window=v["band"]),
                          "state": v["state"], "edges": v["edges"], "graph": ref["pp_graph"]}
                   for name, v in ref["pp"].items()}

    sp_plans = {(tp, n): halo.build_halo_plan(b.nbr_idx, b.nbr_mask, tp)
                for n, b in ref["sp_batches"].items() for tp in {t for _, t in SP_SHAPES}}

    def tp(shape, model, state, steps, config, **kw):
        return {"module": WORKER, "job": "tp_steps", "shape": shape, "model": model,
                "state": state, "steps": steps, "config": config, **kw}

    st = ref["sp_train"]
    sp_plan = halo.build_halo_plan(st["batch"].nbr_idx, st["batch"].nbr_mask, 2)
    dropout_steps = [(e, None) for e in SP_TRAIN_EPOCHS]
    jax_steps = list(zip(SP_TRAIN_EPOCHS, st["draws"]))

    def sp_train(shape, steps, dropout, plan=sp_plan, **kw):
        return {"module": WORKER, "job": "sp_train", "shape": shape, "batch": st["batch"],
                "plan": plan, "steps": steps, "model": {**SP_TRAIN, "dropout": dropout},
                "state": st["state0"], "config": CFG, **kw}

    specs = {
        "tp22_pretrain": tp((2, 2), MODEL, state0, pre_steps, CFG, validate=[(t4, 0), (t4, 1)]),
        "tp22_spmd": tp((2, 2), SPMD_MODEL, ref["spmd_state0"], spmd_steps, SPMD_CFG),
        "checkpoint": {"module": WORKER, "job": "tp_checkpoint", "shape": (2, 2),
                       "model": MODEL, "state": state0, "config": CFG, "batch": t4,
                       "epoch": 1, "dir": str(tmp / "ckpt")},
        **{f"ep_{case}": {"module": WORKER, "job": "ep_block", "shape": (2, 2),
                          "moe": {**MOE, **kw}, "state": moe_states[case], "x": moe_x,
                          "mask": moe_mask} for case, kw in MOE_CASES.items()},
        "halo": {"module": WORKER, "job": "halo", "batch": port_halo_batch, "plan": plan,
                 "conv": (16, 24, 3), "conv_state": ref["conv_state"], "one": one,
                 "one_plan": one_plan},
        "sp_model": {"module": WORKER, "job": "sp_model", "model": SP_MODEL,
                     "state": ref["sp_state"], "batches": ref["sp_batches"], "plans": sp_plans,
                     "shapes": SP_SHAPES},
        "sp_set2set": {"module": WORKER, "job": "sp_model", "model": SP_SET2SET,
                       "state": ref["s2s_state"], "batches": ref["s2s_batches"],
                       "plans": sp_plans, "shapes": SP_SHAPES},
        "sp_train22_dropout": sp_train((2, 2), dropout_steps, 0.1),
        "sp_train22_jax": sp_train((2, 2), jax_steps, 0.0),
        "halo_grads": {"module": WORKER, "job": "halo_grads", "batch": port_halo_batch,
                       "plan": plan, "conv": (16, 24, 3), "conv_state": ref["conv_state"],
                       "gather_cot": ref["halo_grads"]["gather_cot"],
                       "conv_cot": ref["halo_grads"]["conv_cot"]},
        "pp": {"module": WORKER, "job": "pp", "variants": pp_variants, "num_micro": 2},
        "collectives": {"module": WORKER, "job": "collectives"},
        "dryrun": {"module": WORKER, "job": "dryrun"},
        # two ranks, then one: the others sit these out
        "tp12_pretrain": tp((1, 2), MODEL, state0, pre_steps, CFG, world=2),
        "tp12_spmd": tp((1, 2), SPMD_MODEL, ref["spmd_state0"], spmd_steps, SPMD_CFG,
                        world=2),
        "sp_train12_dropout": sp_train((1, 2), dropout_steps, 0.1, world=2),
        "sp_train12_jax": sp_train((1, 2), jax_steps, 0.0, world=2),
        # the data-parallel run that (2, 2) with dropout is held to
        "sp_dp21_dropout": sp_train((2, 1), dropout_steps, 0.1, plan=None, world=2),
        "one_rank": {"module": WORKER, "job": "one_rank", "world": 1, "model": MODEL,
                     "state": state0, "config": CFG, "batch": t4},
    }
    # the JAX node-sharded steps compile while the ranks work
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn_ranks, 4, list(specs.values()), tmp, timeout=600)
        with jax.default_matmul_precision("float32"):
            jax_sp_train_steps(ref)
        ranks = spawned.result()
    got = {name: [r[i] for r in ranks] for i, name in enumerate(specs)}

    single = {"pretrain": single_run(state0, pre_steps, [(t4, 0, None), (t4, 1, None)]),
              "one_rank": single_run(state0, [(t4, 0, None)]),
              "spmd": single_run(ref["spmd_state0"], spmd_steps, model=SPMD_MODEL,
                                 config=SPMD_CFG),
              "sp": sp_one_process(ref["sp_state"], ref["sp_batches"]),
              "s2s": sp_one_process(ref["s2s_state"], ref["s2s_batches"], SP_SET2SET),
              "sp_train_dropout": single_run(st["state0"], [(st["batch"], e, d) for e, d in
                                                            dropout_steps],
                                             model={**SP_TRAIN, "dropout": 0.1}),
              "sp_train_jax": single_run(st["state0"], [(st["batch"], e, d) for e, d in
                                                        jax_steps], model=SP_TRAIN)}
    return {"ref": ref, "got": got, "single": single, "plan": plan, "one_plan": one_plan,
            "moe": (moe_x, moe_mask, moe_states), "state0": state0}


def _metrics_close(got, ref, what, rtol=1e-5):
    for i, (a, b) in enumerate(zip(got, ref)):
        assert set(a) == set(b), what
        for key in b:
            assert abs(a[key] - b[key]) <= rtol * max(1.0, abs(b[key])), \
                f"{what} step {i} {key}: {a[key]} vs {b[key]}"


@pytest.mark.parametrize("scenario", ["tp22_pretrain", "tp12_pretrain", "tp22_spmd",
                                      "tp12_spmd"])
def test_tp_steps_equal_one_process(par, scenario):
    """(2, 2) and (1, 2) ranks report the same metrics on every rank, within
    1e-5 of one process's; the gathered parameters within 1e-5 (the key
    biases to the summed learning rate); validation within 1e-5."""
    ranks = [r for r in par["got"][scenario] if r is not None]
    single = par["single"]["pretrain" if "pretrain" in scenario else "spmd"]
    cfg = CFG if "pretrain" in scenario else SPMD_CFG
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    _metrics_close(ranks[0]["metrics"], single["metrics"], scenario)
    for a, b in zip(ranks[0]["validation"], single["validation"]):
        for key in b:
            got = a[key][:b[key].shape[0]] if b[key].dim() else a[key]
            np.testing.assert_allclose(got.numpy(), b[key].numpy(), atol=1e-5, rtol=1e-5)
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], ranks[0]["params"][k]) for k in r["params"])
    n = len(ranks[0]["metrics"])
    assert_params_close(ranks[0]["params"], single["params"], n * cfg["learning_rate"],
                        scenario)
    # each rank holds shards of the laid-out kernels and of their moments
    assert ranks[0]["layout"] and all(r["layout"] == ranks[0]["layout"] for r in ranks)
    full = sum(p.numel() * 4 for p in single["params"].values())
    assert all(r["bytes"][0] < full and r["bytes"][1] < 2 * full for r in ranks)
    shard = next(iter(ranks[0]["layout"]))
    assert ranks[0]["local"][shard].shape != ranks[0]["params"][shard].shape


@pytest.mark.parametrize("scenario", ["tp22_spmd", "tp12_spmd"])
def test_tp_steps_match_the_jax_trainer_on_one_device(par, scenario):
    """The JAX test's bounds (tests/test_spmd.py::test_tp_training_matches_dp_only):
    each loss within rel 2e-4, parameters within atol 2e-4."""
    got = next(r for r in par["got"][scenario] if r is not None)
    for a, b in zip(got["metrics"], par["ref"]["spmd_jax"]):
        assert a["loss"] == pytest.approx(float(b["loss"]), rel=2e-4)
    ref = par["ref"]["spmd_jax_params"]
    assert set(got["params"]) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(got["params"][key].numpy(), value.numpy(), atol=2e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["full", "moe"])
def test_tp_layout_equals_jax_leaf_for_leaf(par, name):
    """The port's layout rule on its own parameters, named by their JAX paths,
    equals ``tp_param_specs`` of the JAX tree, leaf for leaf; no DenseGeneral
    site, GraphConvolution bias or MoE expert leaf is model-sharded."""
    kw = MODEL if name == "full" else {**MODEL, "moe_experts": 4}
    model = DGDMModel(**kw)
    tree = nest(params_to_flax(dict(model.named_parameters()), model))
    mesh = Mesh(("data", "model"), (2, 4))
    ours = flatten_specs(tp_param_specs(tree, mesh))
    theirs = par["ref"][f"tp_specs_{name}"]
    assert ours == theirs
    assert describe_sharding(tree, mesh) == par["ref"][f"tp_counts_{name}"]
    assert any(s == (None, "model") for s in ours.values())
    general = {f"params/{n.replace('.', '/')}/kernel" for n, m in model.named_modules()
               if isinstance(m, DenseGeneral)}
    conv_bias = {p for p in ours if p.endswith(("conv1/bias", "conv2/bias"))}
    experts = {p for p in ours if p.rsplit("/", 1)[-1] in ("w_in", "b_in", "w_out", "b_out")}
    assert general and conv_bias and (experts or name == "full")
    assert all(ours[p] == () for p in general | conv_bias | experts)


def test_ep_layout_equals_jax_and_the_block_matches_replicated(par):
    model = DGDMModel(**MODEL, moe_experts=4)
    tree = nest(params_to_flax(dict(model.named_parameters()), model))
    specs = ep_param_specs(tree, Mesh(("data", "expert"), (2, 4)))
    assert flatten_specs(specs) == par["ref"]["ep_specs"]
    assert count_expert_sharded(specs) == par["ref"]["ep_count"] == 4


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_expert_parallel_block_equals_the_replicated_block(par, case):
    """Experts split over an expert axis of 2 (data 2): output, aux loss and
    the gradients of x, the router and each rank's experts within 2e-5 of
    the replicated block; the routing equal."""
    x, mask, states = par["moe"]
    ref = MoEFFN(**MOE, **MOE_CASES[case])
    ref.load_state_dict(states[case])
    xr = x.clone().requires_grad_()
    out, aux = ref(xr, mask)
    ((out ** 2).sum() + aux).backward()
    kept = ref.route(x, mask)["kept"]
    if case == "top2_drops":
        assert (kept.sum(-1) == 0).logical_and(mask.reshape(kept.shape[:2])).any()
    for r in par["got"][f"ep_{case}"]:
        assert r["placed"] == 4 and torch.equal(r["kept"], kept)
        np.testing.assert_allclose(r["out"].numpy(), out.detach().numpy(), atol=2e-5, rtol=0)
        np.testing.assert_allclose(float(r["aux"]), float(aux), atol=2e-5, rtol=0)
        np.testing.assert_allclose(r["dx"].numpy(), xr.grad.numpy(), atol=2e-5, rtol=0)
        for name, p in ref.named_parameters():
            g = p.grad
            if name in ("w_in", "b_in", "w_out", "b_out"):
                g = g[2 * r["index"]:2 * r["index"] + 2]
            np.testing.assert_allclose(r["grads"][name].numpy(), g.numpy(), atol=2e-5,
                                       rtol=0, err_msg=name)


def test_halo_host_functions_equal_jax(par):
    """``spatial_sort``, ``build_halo_plan`` and ``halo_fraction`` agree with
    the JAX package's bit for bit; a too-small ``halo_size`` raises."""
    raw = [make_synthetic_graph(seed=i, n_nodes=64, n_real=56, feat_dim=16) for i in range(4)]
    for g in raw:
        ours, theirs = halo.spatial_sort(to_torch_graph(g)), jhalo.spatial_sort(g)
        for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask"):
            assert np.array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))), f
    hb, jplan = par["ref"]["halo_batch"], par["ref"]["halo_plan"]
    plan = par["plan"]
    assert np.array_equal(plan.send_idx, jplan.send_idx)
    assert np.array_equal(plan.nbr_idx_local, jplan.nbr_idx_local)
    assert (plan.halo_size, plan.n_local, plan.tp) == (jplan.halo_size, jplan.n_local, 4)
    for tp in (2, 4, 8):
        assert halo.halo_fraction(np.asarray(hb.nbr_idx), np.asarray(hb.nbr_mask), tp) == \
            jhalo.halo_fraction(hb.nbr_idx, hb.nbr_mask, tp)
    fixed = halo.build_halo_plan(hb.nbr_idx, hb.nbr_mask, tp=4, halo_size=plan.halo_size + 3)
    assert fixed.halo_size == plan.halo_size + 3
    with pytest.raises(ValueError, match="too small"):
        halo.build_halo_plan(hb.nbr_idx, hb.nbr_mask, tp=4, halo_size=0)
    with pytest.raises(ValueError, match="too small"):
        jhalo.build_halo_plan(hb.nbr_idx, hb.nbr_mask, tp=4, halo_size=0)


def test_halo_gather_equals_jax_to_the_bit_and_sp_graph_conv(par):
    """Rank i's block of ``halo_gather`` (model axis of 4) equal to the bit to
    JAX's on a (2, 4) mesh of virtual CPU devices, batched and unbatched;
    ``sp_graph_conv`` within 1e-5 of JAX's and of the port's
    ``GraphConvolution`` on the whole batch (real nodes)."""
    ref = par["ref"]
    n_loc = par["plan"].n_local
    conv = GraphConvolution(16, 24, 3)
    conv.load_state_dict(ref["conv_state"])
    hb = to_torch_graph(ref["halo_batch"])
    with torch.no_grad():
        dense = conv(hb.x, hb.nbr_idx, hb.nbr_mask, hb.edge_attr).numpy()
    node = np.asarray(ref["halo_batch"].node_mask)[..., None]
    for i, r in enumerate(par["got"]["halo"]):
        block = slice(i * n_loc, (i + 1) * n_loc)
        assert np.array_equal(r["gather"].numpy(), ref["halo_gather"][:, block])
        one = slice(i * 16, (i + 1) * 16)
        assert np.array_equal(r["one"].numpy(), ref["one_gather"][one])
        np.testing.assert_allclose(r["sp"].numpy() * node[:, block],
                                   ref["sp"][:, block] * node[:, block], atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["sp"].numpy() * node[:, block],
                                   dense[:, block] * node[:, block], atol=1e-5, rtol=0)
        assert torch.equal(r["block"].nbr_idx, hb.nbr_idx[:, block])


@pytest.mark.parametrize("n", SP_BUCKETS)
@pytest.mark.parametrize("shape", SP_SHAPES)
def test_sp_forward_matches_jax_and_one_process(par, shape, n):
    """``sp_forward`` of the tiny Base on Morton-sorted graphs of bucket n,
    over (data, model) ``shape``: each rank's logits within 1e-4 of JAX
    ``DGDMModel.apply`` and 1e-5 of the port's one-process forward (the
    other heads and the graph embedding 1e-5 too), equal on every rank of a
    model line; every pooled level's selection equal to one process's; the
    rank's ``node_embeddings`` within 1e-5 of its block of one process's."""
    dp, tp = shape
    rows, n_loc = SP_GRAPHS // dp, n // tp
    one, jax_ref = par["single"]["sp"][n], par["ref"]["sp_forward"][n]
    ranks = [r[shape, n] for r in par["got"]["sp_model"]]
    for rank, out in enumerate(ranks):
        d, m = divmod(rank, tp)
        b = slice(d * rows, (d + 1) * rows)
        for key in ("classification_logits", "graph_embedding"):
            np.testing.assert_allclose(out[key].numpy(), jax_ref[key][b], atol=1e-4, rtol=0,
                                       err_msg=key)
        for got, want in ((out["classification_logits"], one["classification_logits"]),
                          (out["graph_embedding"], one["graph_embedding"]),
                          (out["regression"]["mean"], one["regression"]["mean"]),
                          (out["survival"]["survival"], one["survival"]["survival"]),
                          (out["node_embeddings"],
                           one["node_embeddings"][:, m * n_loc:(m + 1) * n_loc])):
            np.testing.assert_allclose(got.numpy(), want[b].numpy(), atol=1e-5, rtol=0)
        assert len(out["pool_sel_idx"]) == 2
        for got, want in zip(out["pool_sel_idx"], one["pool_sel_idx"]):
            assert torch.equal(got, want[b])
        assert torch.equal(out["classification_logits"],
                           ranks[d * tp]["classification_logits"])


@pytest.mark.parametrize("shape", SP_SHAPES)
def test_sp_forward_set2set_matches_jax_and_one_process(par, shape):
    """The Set2Set readout (over the level gathered whole on every rank) of
    the tiny Base on bucket 32: logits and graph embedding within 1e-4 of
    JAX and 1e-5 of the port's one-process forward, equal on every rank of
    a model line."""
    dp, tp = shape
    rows = SP_GRAPHS // dp
    one, jax_ref = par["single"]["s2s"][32], par["ref"]["s2s_forward"][32]
    ranks = [r[shape, 32] for r in par["got"]["sp_set2set"]]
    for rank, out in enumerate(ranks):
        d = rank // tp
        b = slice(d * rows, (d + 1) * rows)
        for key in ("classification_logits", "graph_embedding"):
            np.testing.assert_allclose(out[key].numpy(), jax_ref[key][b], atol=1e-4, rtol=0,
                                       err_msg=key)
            np.testing.assert_allclose(out[key].numpy(), one[key][b].numpy(), atol=1e-5,
                                       rtol=0, err_msg=key)
        assert torch.equal(out["classification_logits"],
                           ranks[d * tp]["classification_logits"])


@pytest.mark.parametrize("option", ["mode", "dropout", "return_attention", "moe",
                                    "spatial_window", "graph_window", "use_flash", "remat"])
def test_sp_forward_refuses_the_options_it_does_not_cover(option):
    """Returned attention, the MoE, DGDM-Large's windows, flash attention and
    remat under a gradient raise naming ROADMAP item 12. Training modes
    work: over a model axis of 1, ``mode="pretrain"`` gives the model's
    diffusion loss on the same draws, and ``deterministic=False`` the
    model's dropout from the same generator state, within 1e-6."""
    kw = {"moe": {"moe_experts": 4}, "spatial_window": {"spatial_window": 8},
          "graph_window": {"graph_window": 8}, "remat": {"use_remat": True},
          "dropout": {"dropout": 0.1}}.get(option, {})
    model = init_parameters(DGDMModel(**{**SP_MODEL, **kw}), torch.Generator().manual_seed(5))
    if option == "use_flash":
        model.spatial_attention.use_flash = True
    g = to_torch_graph(sp_batch(32))
    mesh = Mesh(("data", "model"), (1, 1))
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=1)
    if option in ("mode", "dropout"):
        call = ({"mode": "pretrain", "deterministic": False} if option == "mode"
                else {"mode": "finetune", "deterministic": False})
        got = sp_forward(model, g, plan, mesh, generator=torch.Generator().manual_seed(9),
                         **call)
        want = model(g, generator=torch.Generator().manual_seed(9), **call)
        keys = ("diffusion_loss", "classification_logits") if option == "mode" else \
            ("node_embeddings", "classification_logits")
        for key in keys:
            torch.testing.assert_close(got[key], want[key], atol=1e-6, rtol=1e-6)
        return
    call = {"return_attention": {"return_attention": True}}.get(option, {})
    with pytest.raises(NotImplementedError, match="item 12"):
        sp_forward(model, g, plan, mesh, **call)


def test_sp_forward_rejects_a_level_that_does_not_divide():
    """A 24-node bucket over a model axis of 4: 24 and 12 divide, the second
    pooled level's 6 nodes do not."""
    g = to_torch_graph(j_batch([make_synthetic_graph(seed=0, n_nodes=24, n_real=20,
                                                     feat_dim=16)] * 2))
    mesh = Mesh(("data", "model"), (1, 4), lines={"model": Axis("model", 4, 0)})
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=4)
    model = DGDMModel(**SP_MODEL)
    assert level_sizes(model, 24) == [24, 12, 6]
    with pytest.raises(ValueError, match="6 nodes is not divisible by model axis 4"):
        sp_forward(model, shard_graph_nodes(g, mesh), plan, mesh)


@pytest.mark.parametrize("variant", ["edges", "no_edges", "banded"])
def test_pipeline_matches_jax_and_the_sequential_encoder(par, variant):
    """4 stages of one layer, 2 microbatches: the output on every rank within
    1e-4 of JAX ``pp_graph_encoder_apply`` and of the port's sequential
    encoder; the gradients of ``sum(out ** 2)`` (each layer's from its
    stage, the projections' from any rank) within 1e-4 of the sequential
    encoder's and, with edges, of JAX's."""
    ref = par["ref"]["pp"][variant]
    g = par["ref"]["pp_graph"]
    enc = port_encoder(ref["band"], ref["state"])
    seq = enc(g.x, g.nbr_idx, g.nbr_mask, g.node_mask,
              edge_attr=g.edge_attr if ref["edges"] else None)["embeddings"]
    (seq ** 2).sum().backward()
    seq_grads = {k: p.grad for k, p in enc.named_parameters() if p.grad is not None}
    ranks = [r[variant] for r in par["got"]["pp"]]
    grads = dict(ranks[0]["grads"])
    for stage, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"].numpy(), ref["out"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["out"].numpy(), seq.detach().numpy(), atol=1e-4,
                                   rtol=1e-4)
        for k, v in r["grads"].items():
            if k.startswith("layer"):
                if k.startswith(f"layer{stage}."):
                    grads[k] = v
                else:
                    assert not v.any(), (stage, k)
            else:
                assert torch.equal(v, ranks[0]["grads"][k]), k
    assert set(grads) == set(seq_grads)
    for k, v in seq_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    if variant == "edges":
        jg = par["ref"]["pp_jax_grads"]
        for k, v in jg.items():
            np.testing.assert_allclose(grads[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_tp_checkpoint_round_trip_restores_the_layout(par):
    """Rank 0 saves whole tensors (one process's shapes); every rank restores
    them into a fresh (2, 2) trainer: its shards and AdamW moments equal to
    the saving trainer's, and the next step equal on both."""
    one = DGDMModel(**MODEL)
    for r in par["got"]["checkpoint"]:
        assert r["same_params"] and r["same_moments"] and r["sharded"] > 0
        assert r["saved_shapes"] == {k: tuple(v.shape) for k, v in one.state_dict().items()}
        assert r["moment_shapes"] == [tuple(p.shape) for p in one.parameters()]
        assert r["next"][0] == r["next"][1]


def test_dryrun_multichip_on_four_ranks(par):
    outs = par["got"]["dryrun"]
    line = outs[0]["line"]
    for part in ("dryrun_multichip(4) OK", "tp_sharded_params=", "sp_graph_conv_parity_ok",
                 "sp_logits_finite=(2, 2)", "sp_forward_parity_ok", "halo_gather_parity_ok",
                 "pp_parity_ok(stages=2)", "ep_parity_ok(experts=4/ep=2)", "combined=skipped"):
        assert part in line, line
    assert "queued" not in line and outs[0]["sp_forward_err"] <= 1e-4
    assert all(o["pretrain_loss"] == outs[0]["pretrain_loss"] for o in outs)
    assert np.isfinite(outs[0]["windowed_banded_loss"]) and outs[0]["tp_sharded_params"] > 0


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the dry run runs on the card
    unless asked for the CPU, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)


def test_the_validation_errors_jax_raises():
    """Indivisible layers, a bad ``num_micro``, a batch that does not split
    into microbatches, an indivisible node bucket, a too-small halo."""
    mesh = Mesh(("data", "pipe"), (1, 4), lines={"pipe": Axis("pipe", 4, 0)})
    layer = GraphEncoder(16, PP_HID, 1, PP_HEADS).layer0
    with pytest.raises(ValueError, match="divisible"):
        make_pp_layers_fn(mesh, layer, torch.tanh, num_layers=3, num_micro=2)
    with pytest.raises(ValueError, match="num_micro"):
        make_pp_layers_fn(mesh, layer, torch.tanh, num_layers=4, num_micro=0)
    fn = make_pp_layers_fn(mesh, layer, torch.tanh, num_layers=4, num_micro=2,
                           has_edges=False)
    h = torch.zeros(3, 8, PP_HID)
    with pytest.raises(ValueError, match="num_micro"):
        fn({}, h, torch.zeros(3, 8, 2, dtype=torch.int32), torch.ones(3, 8, 2, dtype=bool))
    g = to_torch_graph(j_batch([make_synthetic_graph(seed=0, n_nodes=30, n_real=28,
                                                     feat_dim=16)] * 2))
    nodes = Mesh(("data", "model"), (1, 4), lines={"model": Axis("model", 4, 0)})
    with pytest.raises(ValueError, match="divisible"):
        shard_graph_nodes(g, nodes)
    with pytest.raises(ValueError, match="too small"):
        halo.build_halo_plan(np.asarray([[1, 0]] * 4), np.ones((4, 2), bool), tp=2,
                             halo_size=0)


def test_trainer_from_a_model_mesh_config():
    """``hardware.mesh_shape`` [1, 2] with axes [data, model] asks for two
    ranks; a trainer on a mesh without a model axis keeps every parameter
    whole."""
    from dgdm_histopath_torch.utils.config import load_config
    cfg = load_config(None, overrides={
        "model": {"node_features": 16, "hidden_dims": [32, 16], "num_diffusion_steps": 3,
                  "attention_heads": 4, "graph_layers": 1, "compute_dtype": "float32"},
        "hardware": {"mesh_shape": [1, 2], "mesh_axes": ["data", "model"]}})
    with pytest.raises(ValueError, match="needs 2 ranks"):
        DGDMTrainer.from_config(cfg, device="cpu")
    tt = DGDMTrainer(DGDMModel(**SPMD_MODEL), TrainerConfig(**SPMD_CFG), device="cpu")
    tt.init_state(0)
    assert tt.model.tp_layout == {} and tt._tp is None


def test_rectangular_tables_on_the_cpu_and_forward_only():
    """The plain versions take a table of M rows read by N rows of K slots
    (as the halo tier's gathers do): each gathered row is its table row,
    out-of-range slots zero, the sum its weighted rows; and the backward of
    such a call, once forward only, gives the table's gradient [B, M, F]
    (and the weights') within 1e-6 of the f64 autograd of a dense gather."""
    from dgdm_histopath_torch.ops.kernels.gather_agg import weighted_gather_sum
    from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows

    g = torch.Generator().manual_seed(0)
    src = torch.randn(2, 11, 6, generator=g)
    idx = torch.randint(-1, 12, (2, 4, 3), generator=g, dtype=torch.int32)
    w = torch.rand(2, 4, 3, generator=g)
    rows = gather_rows(src, idx)
    valid = (idx >= 0) & (idx < 11)
    want = torch.stack([src[b][idx[b].clamp(0, 10).long()] for b in range(2)])
    assert torch.equal(rows, want * valid[..., None])
    torch.testing.assert_close(weighted_gather_sum(src, idx, w),
                               (want * (w * valid)[..., None]).sum(-2), atol=1e-6, rtol=1e-6)
    leaf, lw = src.clone().requires_grad_(), w.clone().requires_grad_()
    ref, rw = src.double().requires_grad_(), w.double().requires_grad_()

    def dense():
        return torch.stack([ref[b][idx[b].clamp(0, 10).long()] for b in range(2)]) * \
            valid[..., None]

    for out, want in ((gather_rows(leaf, idx), dense()),
                      (weighted_gather_sum(leaf, idx, lw), (dense() * rw[..., None]).sum(-2))):
        cot = torch.randn(out.shape, generator=g)
        (out * cot).sum().backward()
        (want * cot.double()).sum().backward()
    assert leaf.grad.shape == (2, 11, 6)
    torch.testing.assert_close(leaf.grad.double(), ref.grad, atol=1e-6, rtol=0)
    torch.testing.assert_close(lw.grad.double(), rw.grad, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", ["(1, 2)", "(2, 2)"])
def test_sp_training_with_dropout_equals_one_process(par, shape):
    """``training_step(block, epoch, prepared=True, plan=plan)`` with dropout
    0.1 and the generator's draws, 3 pretrain and 1 finetune steps: every
    rank reports the same metrics, within 1e-5 of max(1, |x|) of the
    reference's, and holds the same parameters, within 1e-5 (the key biases
    to the steps' summed learning rate). At (1, 2) the reference is one
    process on the whole batch; at (2, 2) the data-parallel (2, 1) run, whose
    data ranks draw dropout from streams of their own."""
    name = "12" if shape == "(1, 2)" else "22"
    ranks = [r for r in par["got"][f"sp_train{name}_dropout"] if r is not None]
    assert len(ranks) == (2 if name == "12" else 4)
    ref = (par["single"]["sp_train_dropout"] if name == "12"
           else par["got"]["sp_dp21_dropout"][0])
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    _metrics_close(ranks[0]["metrics"], ref["metrics"], f"sp {shape} dropout")
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], ranks[0]["params"][k]) for k in r["params"])
    params = {k: v for k, v in ranks[0]["params"].items() if k in ref["params"]}
    assert_params_close(params, ref["params"], len(SP_TRAIN_EPOCHS) * CFG["learning_rate"],
                        f"sp {shape} dropout")


@pytest.mark.parametrize("shape", ["(1, 2)", "(2, 2)"])
def test_sp_training_matches_jax_and_one_process(par, shape):
    """The same steps without dropout, on the JAX draws: metrics within 1e-5
    of one port process on the whole batch and parameters within 1e-5 (the
    key biases to the summed learning rate); against JAX
    ``training_step(shard_graph_nodes(batch, mesh), prepared=True)`` on a
    (2, 2) mesh every loss within rel 2e-4 and the parameters within atol
    2e-4 (the JAX test's bounds)."""
    name = "12" if shape == "(1, 2)" else "22"
    got = next(r for r in par["got"][f"sp_train{name}_jax"] if r is not None)
    one = par["single"]["sp_train_jax"]
    _metrics_close(got["metrics"], one["metrics"], f"sp {shape}")
    params = {k: v for k, v in got["params"].items() if k in one["params"]}
    assert_params_close(params, one["params"], len(SP_TRAIN_EPOCHS) * CFG["learning_rate"],
                        f"sp {shape}")
    jref = par["ref"]["sp_train"]
    for a, b in zip(got["metrics"], jref["jax"]):
        assert set(a) == set(b)
        assert a["loss"] == pytest.approx(float(b["loss"]), rel=2e-4)
    assert set(params) == set(jref["jax_params"])
    for key, value in jref["jax_params"].items():
        np.testing.assert_allclose(params[key].numpy(), value.numpy(), atol=2e-4, err_msg=key)


@pytest.mark.parametrize("fn", ["halo_gather", "sp_graph_conv"])
def test_halo_gradients_match_jax_grad(par, fn):
    """The halo exchange's backward over a model axis of 4: each rank's
    gradient of ``sum(out * cotangent)`` with respect to its block of x,
    stacked in rank order, within 1e-5 of ``jax.grad`` of the JAX function
    on the virtual devices; for ``sp_graph_conv`` also the parameters'
    gradients summed over the ranks (the padded send slots add exact zeros
    into row 0)."""
    ref = par["ref"]["halo_grads"]
    key = "gather_dx" if fn == "halo_gather" else "conv_dx"
    ranks = par["got"]["halo_grads"]
    dx = torch.cat([r[key] for r in ranks], 1)
    np.testing.assert_allclose(dx.numpy(), ref[key], atol=1e-5, rtol=0)
    assert np.abs(ref[key]).max() > 1e-2
    if fn == "sp_graph_conv":
        for name, want in ref["conv_grads"].items():
            got = sum(r["conv_grads"][name] for r in ranks)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)


def test_shard_tree_like_cuts_the_jax_tree_as_the_ranks_hold_it(par):
    """Each (2, 2) rank's own parameters, named and laid out as the JAX tree,
    equal ``shard_tree_like`` of the whole tree under ``tp_param_specs``
    (what ``place_state_tp`` does to the port's modules, JAX's rule on its
    tree)."""
    model = DGDMModel(**SPMD_MODEL)
    for rank, r in enumerate(par["got"]["tp22_spmd"]):
        mesh = Mesh(("data", "model"), (2, 2), lines={"model": Axis("model", 2, rank % 2)})
        whole = nest(params_to_flax(r["params"], model))
        cut = flatten_specs(shard_tree_like(whole, tp_param_specs(whole, mesh), mesh))
        mine = params_to_flax(r["local"], model)
        assert set(cut) == set(mine)
        for path, value in mine.items():
            assert np.array_equal(np.asarray(cut[path]), value), path


def test_stacking_node_layout_and_bubble():
    """``stack_layer_params`` / ``unstack_layer_params`` round trip (a missing
    layer raises); the node layout names (data, model); ``constrain_nodes``
    is the identity; the GPipe bubble."""
    enc = GraphEncoder(16, PP_HID, PP_LAYERS, PP_HEADS)
    stacked = stack_layer_params(enc, PP_LAYERS)
    assert all(t.shape[0] == PP_LAYERS for t in stacked.values())
    back = unstack_layer_params(stacked, PP_LAYERS)
    params = dict(enc.named_parameters())
    assert set(back) == {k for k in params if k.startswith("layer")}
    assert all(torch.equal(back[k], params[k]) for k in back)
    with pytest.raises(ValueError, match="missing"):
        stack_layer_params({"layer0.w": torch.zeros(1)}, 2)
    mesh = Mesh(("data", "model"), (1, 4))
    assert node_sharding(mesh) == ("data", "model")
    assert node_sharding(mesh, batch_sharded=False) == (None, "model")
    h = torch.zeros(2, 3)
    assert constrain_nodes(h, mesh) is h
    assert pp_bubble_fraction(1, 4) == 0.0 and pp_bubble_fraction(4, 4) == pytest.approx(3 / 7)


def test_mesh_lines_and_collectives_with_their_gradients(par):
    """Ranks row-major over (data 2, model 2): rank r at (r // 2, r % 2), its
    lines' ranks; on the CPU gloo runs every collective natively. Each
    autograd collective's gradient is the exact adjoint of its forward (the
    loss a sum over ranks): all_reduce sums back, all_gather sums and cuts,
    all_to_all sends back; the shift takes the previous rank's tensor and
    the broadcast the chosen rank's."""
    got = par["got"]["collectives"]
    w = torch.arange(8.0).view(2, 4)
    xs = [torch.arange(4.0).view(2, 2).add(10 * r) for r in range(4)]
    for r, res in enumerate(got):
        d, m = r // 2, r % 2
        pair = [2 * d, 2 * d + 1]
        assert res["coords"] == (d, m) and res["route"] == "gloo"
        assert res["ranks"] == ((m, 2 + m), tuple(pair))
        y, g = res["reduce"]
        assert torch.equal(y, xs[pair[0]] + xs[pair[1]])
        assert torch.equal(g, 2 * w[:, :2])
        y, g = res["gather"]
        assert torch.equal(y, torch.cat([xs[pair[0]], xs[pair[1]]], 1))
        assert torch.equal(g, 2 * w[:, 2 * m:2 * m + 2])
        y, g = res["a2a"]
        assert torch.equal(y, torch.stack([xs[pair[0]][m], xs[pair[1]][m]]))
        # row j of x went to rank j of the line, where it sits at row m
        assert torch.equal(g, torch.stack([w[m, :2], w[m, :2]]))
        assert float(res["shift"]) == float(pair[1 - m])
        assert float(res["broadcast"]) == float(pair[1])


def test_a_one_rank_process_group_keeps_the_data_parallel_path(par):
    """A world of one rank (one NCCL rank on one card, as chip_smoke's DP
    phase runs it): the data line is the world group, the trainer takes the
    data-parallel path, and its step equals one process's (the draws at the
    global shape are the single process's)."""
    got = par["got"]["one_rank"][0]
    assert got["group"] and got["dp"]
    _metrics_close([got["metrics"]], par["single"]["one_rank"]["metrics"], "one rank")
    assert all(r is None for r in par["got"]["one_rank"][1:])
