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

DGDM-Large's two windows (W 8, the same parameters): ``sp_forward`` at
(1, 2), (2, 2) and (1, 4) on buckets of 32 and 64 with the bounds above,
JAX's forward ``DGDMModel.apply`` on ``shard_graph_nodes(batch, mesh)``; the
returned attention's rows concatenated over a line against one process
(1e-5); the training steps on the JAX draws against one process and the
JAX windowed trainer on a (2, 2) mesh, and with dropout at (1, 2) and
(1, 4) against one process, with the bounds above; ``mesh.shift`` and its
gradient against ``torch.roll``. The JAX windowed references compile in a
second thread beside the spawn.

The MoE and remat over node-sharded inputs: the MoE forward (4 experts,
top-1 and top-2, the JAX model's groups of 1024 tokens inside a block,
over a graph's ranks and over graphs and ranks) at (1, 2), (2, 2) and
(1, 4) against JAX ``apply`` on ``shard_graph_nodes`` (1e-4) and one
process (1e-5, routing equal); MoE training on the JAX draws against one
process and the JAX MoE trainer on a (2, 2) mesh, and with dropout against
one process; remat training against one process with remat, with and
without dropout, and against the JAX remat trainer, with the bounds above.
The JAX MoE references start from the port's parameters and compile in a
third thread.
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
from dgdm_histopath_torch.nn.moe import MoEFFN, routing_group
from dgdm_histopath_torch.ops.graph import band_eligible
from dgdm_histopath_torch.parallel import (constrain_nodes, dryrun_multichip, halo,
                                           level_sizes, make_pp_layers_fn, node_sharding,
                                           pp_bubble_fraction, shard_graph_nodes,
                                           shard_tree_like, sp_forward, stack_layer_params,
                                           unstack_layer_params)
from dgdm_histopath_torch.parallel.ep import count_expert_sharded, ep_param_specs
from dgdm_histopath_torch.parallel.mesh import Axis, Mesh, shift
from dgdm_histopath_torch.parallel.tp import (describe_sharding, flatten_specs, nest,
                                              tp_param_specs)
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig
from test_torch_dp import CFG, MODEL, assert_params_close, jax_batch, single_run
from test_torch_model import _flat
from test_torch_training import SHIFT_INVARIANT_BIASES, jax_draws, to_torch_graph
from torch_dp_worker import spawn_ranks
from torch_parallel_worker import routing_codes

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
# DGDM-Large's two windows at a CPU size, W 8: the forward's tiny Base and
# the training model with both windows (the same parameters), on buckets of
# 32 (4 windows: one a rank over a model axis of 4) and 64
WIN = dict(spatial_window=8, graph_window=8)
SP_WIN, SP_WIN_TRAIN = {**SP_MODEL, **WIN}, {**SP_TRAIN, **WIN}
SP_WIN_SHAPES = ((1, 2), (2, 2), (1, 4))
RING_OFFSETS = (1, -1, 2)
# The MoE over node blocks: the tiny Base with 4 experts and without the
# U-Net (the training model below keeps it), top-1 (capacity 1.0) and top-2
# (capacity 0.5: the second slot mostly dropped). The JAX
# model routes in groups of 1024 tokens: 2 graphs of 2048 nodes put a group
# inside a block at tp 2 (over two blocks at tp 4), 2 graphs of 1024 one
# graph's group over the ranks' blocks, 8 graphs of 256 a group over 4
# graphs and every block of them; no group straddles the data ranks of
# (2, 2). JAX's forward on shard_graph_nodes of each batch runs on the mesh
# named here, where the batch takes its placement.
SP_MOE = {**SP_MODEL, "moe_experts": 4, "use_hierarchical": False}
SP_MOE_TOPK = {"top1": dict(moe_top_k=1, moe_capacity=1.0),
               "top2": dict(moe_top_k=2, moe_capacity=0.5)}
SP_MOE_BATCHES = {"2x2048": (2, 2048), "2x1024": (2, 1024), "8x256": (8, 256)}
SP_MOE_JAX_MESH = {"2x2048": (1, 2), "2x1024": (1, 4), "8x256": (2, 2)}
SP_MOE_SHAPES = ((1, 2), (2, 2), (1, 4))
# node-sharded training with the MoE (top-2, capacity 0.5) and with remat
SP_TRAIN_MOE = {**SP_TRAIN, "moe_experts": 4, "moe_top_k": 2, "moe_capacity": 0.5}
SP_TRAIN_REMAT = {**SP_TRAIN, "use_remat": True}
# the remat runs on the JAX draws and the JAX remat trainer take the 3
# pretrain steps (the runs with dropout take the finetune step too)
SP_REMAT_JAX_EPOCHS = SP_TRAIN_EPOCHS[:3]


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
    # the models with both windows and with remat have the same parameters:
    # their trainers start from copies of the state (the steps donate
    # theirs), with the same draws
    jw = jtr.DGDMTrainer(JaxDGDM(**SP_WIN_TRAIN, gather_impl="xla"),
                         jtr.TrainerConfig(**CFG, allow_out_of_band_graphs=True), mesh=jmesh)
    jr = jtr.DGDMTrainer(JaxDGDM(**SP_TRAIN_REMAT, gather_impl="xla"), jtr.TrainerConfig(**CFG),
                         mesh=jmesh)
    for other in (jw, jr):
        other.state = jax.tree_util.tree_map(
            lambda a: jax.device_put(np.asarray(a), a.sharding), state)
    ref["sp_train"] = {"trainer": jt, "win_trainer": jw, "remat_trainer": jr,
                       "jmesh": jmesh, "block": jax_shard_nodes(batch, jmesh),
                       "state0": params_from_flax(_flat(params0)), "draws": draws,
                       "batch": to_torch_graph(batch)}


def jax_sp_train_steps(ref, prefix="", epochs=SP_TRAIN_EPOCHS):
    """JAX ``training_step(shard_graph_nodes(batch, mesh), prepared=True)``
    (``prefix="win_"``: of the model with both windows, ``"remat_"``: with
    remat)."""
    r = ref["sp_train"]
    jt = r.pop(f"{prefix}trainer")
    r[f"{prefix}jax"] = [jt.training_step(r["block"], e, prepared=True) for e in epochs]
    r[f"{prefix}jax_params"] = params_from_flax(_flat(jax.device_get(jt.state.params)))


def jax_sp_windowed(ref):
    """The JAX references of the windowed model over node-sharded inputs:
    ``DGDMModel.apply`` of the tiny Base with both windows on
    ``shard_graph_nodes(batch, mesh)`` at each shape and bucket (GSPMD
    partitions it), then the windowed training model's node-sharded steps."""
    with jax.default_matmul_precision("float32"):
        jm = JaxDGDM(**SP_WIN, gather_impl="xla")
        fwd = jax.jit(lambda p, g: jm.apply(p, g, mode="inference", deterministic=True))
        ref["win_forward"] = {}
        for dp, tp in SP_WIN_SHAPES:
            jmesh = jax_make_mesh(n_devices=dp * tp, axes=("data", "model"), shape=(dp, tp))
            for n, batch in ref["sp_jax_batches"].items():
                out = fwd(ref["sp_params"], jax_shard_nodes(batch, jmesh))
                ref["win_forward"][(dp, tp), n] = {
                    k: np.asarray(out[k]) for k in ("classification_logits", "graph_embedding")}
        jax_sp_train_steps(ref, "win_")


def sp_batch(n, graphs=SP_GRAPHS, seed=20):
    """Morton-sorted graphs of bucket n with 4 or more padding nodes each."""
    return j_batch([jhalo.spatial_sort(make_synthetic_graph(seed=seed + i, n_nodes=n,
                                                            n_real=n - 4 - i, feat_dim=16))
                    for i in range(graphs)])


def jax_sp_moe(ref, moe):
    """The JAX references of the MoE over node blocks, from the port's
    parameters: ``DGDMModel.apply`` of each top-k model on
    ``shard_graph_nodes`` of each batch over its mesh (``SP_MOE_JAX_MESH``),
    and the MoE training model's node-sharded steps on a (2, 2) mesh, from
    the plain trainer's draws (its rng, fold_in(key, 7), is the model's
    own)."""
    with jax.default_matmul_precision("float32"):
        params = nest(params_to_flax(moe["state"], DGDMModel(**SP_MOE)))
        ref["sp_moe_forward"] = {}
        for name, kw in SP_MOE_TOPK.items():
            jm = JaxDGDM(**SP_MOE, **kw, gather_impl="xla")
            fwd = jax.jit(lambda p, g, jm=jm: jm.apply(p, g, mode="inference",
                                                       deterministic=True))
            for key, batch in moe["jax_batches"].items():
                dp, tp = SP_MOE_JAX_MESH[key]
                jmesh = jax_make_mesh(n_devices=dp * tp, axes=("data", "model"), shape=(dp, tp))
                out = fwd(params, jax_shard_nodes(batch, jmesh))
                ref["sp_moe_forward"][name, key] = {
                    k: np.asarray(out[k])
                    for k in ("classification_logits", "graph_embedding", "moe_aux_loss")}
        r = ref["sp_train"]
        jt = jtr.DGDMTrainer(JaxDGDM(**SP_TRAIN_MOE, gather_impl="xla"), jtr.TrainerConfig(**CFG),
                             mesh=r["jmesh"])
        tree = nest(params_to_flax(moe["train_state"], DGDMModel(**SP_TRAIN_MOE)))
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), tree)
        jt.state = jt.place_state(jtr.TrainState.create(
            params, jt.tx, jax.random.fold_in(jax.random.PRNGKey(11), 7)))
        r["moe_jax"] = [jt.training_step(r["block"], e, prepared=True) for e in SP_TRAIN_EPOCHS]
        r["moe_jax_params"] = params_from_flax(_flat(jax.device_get(jt.state.params)))


def sp_moe_one_process(state, batches):
    """The port's one-process forward of each top-k MoE model on each batch,
    with its routing (``routing_codes``)."""
    out = {}
    for name, kw in SP_MOE_TOPK.items():
        model = DGDMModel(**SP_MOE, **kw)
        model.load_state_dict(state)
        codes = []
        model.moe_ffn.register_forward_hook(
            lambda m, args, kwargs, o: codes.append(routing_codes(m, args, kwargs)),
            with_kwargs=True)
        with torch.no_grad():
            for key, batch in batches.items():
                out[name, key] = model(batch)
                out[name, key]["moe_routing"] = codes.pop()
    return out


def jax_sp_reference(ref, prefix="sp", model=SP_MODEL, buckets=SP_BUCKETS):
    """JAX ``DGDMModel.apply`` (inference) of the tiny Base on each bucket,
    one parameter tree."""
    jm = JaxDGDM(**model, gather_impl="xla")
    batches = {n: sp_batch(n) for n in buckets}
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    params = jm.init(rngs, batches[32], mode="pretrain", deterministic=True)
    fwd = jax.jit(lambda p, g: jm.apply(p, g, mode="inference", deterministic=True))
    ref[f"{prefix}_params"], ref[f"{prefix}_jax_batches"] = params, batches
    ref[f"{prefix}_state"] = params_from_flax(_flat(params))
    ref[f"{prefix}_forward"] = {n: {k: np.asarray(v) for k, v in fwd(params, b).items()
                                    if k in ("classification_logits", "graph_embedding")}
                                for n, b in batches.items()}
    ref[f"{prefix}_batches"] = {n: to_torch_graph(b) for n, b in batches.items()}


def sp_one_process(state, batches, model=SP_MODEL, attention=False):
    """The port's one-process forward of each batch, with every pooled
    level's selection; with ``attention`` also the first batch's with
    ``return_attention=True``, under ``"attention"``."""
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
        if attention:
            out["attention"] = model(next(iter(batches.values())), return_attention=True)
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

    sp_plan4 = halo.build_halo_plan(st["batch"].nbr_idx, st["batch"].nbr_mask, 4)

    def sp_train(shape, steps, dropout, plan=sp_plan, model=SP_TRAIN, state=st["state0"],
                 **kw):
        return {"module": WORKER, "job": "sp_train", "shape": shape, "batch": st["batch"],
                "plan": plan, "steps": steps, "model": {**model, "dropout": dropout},
                "state": state, "config": CFG, **kw}

    # the MoE: the port's parameters (the JAX references take them), its
    # batches and their plans
    moe = {"state": init_parameters(DGDMModel(**SP_MOE), torch.Generator().manual_seed(21)
                                    ).state_dict(),
           "train_state": init_parameters(DGDMModel(**SP_TRAIN_MOE),
                                          torch.Generator().manual_seed(22)).state_dict(),
           "jax_batches": {k: sp_batch(n, graphs, seed=40)
                           for k, (graphs, n) in SP_MOE_BATCHES.items()}}
    moe["batches"] = {k: to_torch_graph(b) for k, b in moe["jax_batches"].items()}
    moe_plans = {(tp, k): halo.build_halo_plan(b.nbr_idx, b.nbr_mask, tp)
                 for k, b in moe["batches"].items() for tp in (2, 4)}

    def sp_moe(shapes, top_k, **kw):
        return {"module": WORKER, "job": "sp_model", "model": {**SP_MOE, **SP_MOE_TOPK[top_k]},
                "state": moe["state"], "batches": moe["batches"], "plans": moe_plans,
                "shapes": shapes, **kw}

    def sp_win(shapes, **kw):
        return {"module": WORKER, "job": "sp_model", "model": SP_WIN, "state": ref["sp_state"],
                "batches": ref["sp_batches"], "plans": sp_plans, "shapes": shapes,
                "attention": True, **kw}

    ring = torch.from_numpy(np.random.RandomState(8).randn(2, 2, 8, 3).astype(np.float32))

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
        "sp_win_4": sp_win([s for s in SP_WIN_SHAPES if s[0] * s[1] == 4]),
        "sp_win22_jax": sp_train((2, 2), jax_steps, 0.0, model=SP_WIN_TRAIN),
        "sp_win14_dropout": sp_train((1, 4), dropout_steps, 0.1, plan=sp_plan4,
                                     model=SP_WIN_TRAIN),
        **{f"sp_moe_{k}_4": sp_moe(((2, 2), (1, 4)), k) for k in SP_MOE_TOPK},
        "sp_moe14_jax": sp_train((1, 4), jax_steps, 0.0, plan=sp_plan4, model=SP_TRAIN_MOE,
                                 state=moe["train_state"]),
        "sp_moe14_dropout": sp_train((1, 4), dropout_steps, 0.1, plan=sp_plan4,
                                     model=SP_TRAIN_MOE, state=moe["train_state"]),
        "sp_remat14_jax": sp_train((1, 4), jax_steps[:3], 0.0, plan=sp_plan4,
                                   model=SP_TRAIN_REMAT),
        "sp_remat14_dropout": sp_train((1, 4), dropout_steps, 0.1, plan=sp_plan4,
                                       model=SP_TRAIN_REMAT),
        "ring_shift": {"module": WORKER, "job": "ring_shift", "x": ring[0], "w": ring[1],
                       "offsets": RING_OFFSETS},
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
        "sp_win_2": sp_win([(1, 2)], world=2),
        "sp_win12_jax": sp_train((1, 2), jax_steps, 0.0, model=SP_WIN_TRAIN, world=2),
        "sp_win12_dropout": sp_train((1, 2), dropout_steps, 0.1, model=SP_WIN_TRAIN,
                                     world=2),
        **{f"sp_moe_{k}_2": sp_moe(((1, 2),), k, world=2) for k in SP_MOE_TOPK},
        "sp_moe12_jax": sp_train((1, 2), jax_steps, 0.0, model=SP_TRAIN_MOE,
                                 state=moe["train_state"], world=2),
        "sp_moe12_dropout": sp_train((1, 2), dropout_steps, 0.1, model=SP_TRAIN_MOE,
                                     state=moe["train_state"], world=2),
        "sp_remat12_jax": sp_train((1, 2), jax_steps[:3], 0.0, model=SP_TRAIN_REMAT, world=2),
        "sp_remat12_dropout": sp_train((1, 2), dropout_steps, 0.1, model=SP_TRAIN_REMAT,
                                       world=2),
        # the data-parallel run that (2, 2) with dropout is held to
        "sp_dp21_dropout": sp_train((2, 1), dropout_steps, 0.1, plan=None, world=2),
        "one_rank": {"module": WORKER, "job": "one_rank", "world": 1, "model": MODEL,
                     "state": state0, "config": CFG, "batch": t4},
    }
    # the JAX node-sharded steps and the windowed, MoE and remat references
    # compile while the ranks work
    with ThreadPoolExecutor(3) as pool:
        spawned = pool.submit(spawn_ranks, 4, list(specs.values()), tmp, timeout=600)
        windowed = pool.submit(jax_sp_windowed, ref)
        moe_refs = pool.submit(jax_sp_moe, ref, moe)
        with jax.default_matmul_precision("float32"):
            jax_sp_train_steps(ref)
            jax_sp_train_steps(ref, "remat_", SP_REMAT_JAX_EPOCHS)
        ranks = spawned.result()
        windowed.result()
        moe_refs.result()
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
                                                        jax_steps], model=SP_TRAIN),
              "sp_win": sp_one_process(ref["sp_state"], ref["sp_batches"], SP_WIN,
                                       attention=True),
              "sp_win_jax": single_run(st["state0"], [(st["batch"], e, d) for e, d in
                                                      jax_steps], model=SP_WIN_TRAIN),
              "sp_win_dropout": single_run(st["state0"], [(st["batch"], e, d) for e, d in
                                                          dropout_steps],
                                           model={**SP_WIN_TRAIN, "dropout": 0.1}),
              "sp_moe": sp_moe_one_process(moe["state"], moe["batches"]),
              "sp_moe_jax": single_run(moe["train_state"], [(st["batch"], e, d) for e, d in
                                                            jax_steps], model=SP_TRAIN_MOE),
              "sp_moe_dropout": single_run(moe["train_state"],
                                           [(st["batch"], e, d) for e, d in dropout_steps],
                                           model={**SP_TRAIN_MOE, "dropout": 0.1}),
              "sp_remat_jax": single_run(st["state0"], [(st["batch"], e, d) for e, d in
                                                        jax_steps[:3]], model=SP_TRAIN_REMAT),
              "sp_remat_dropout": single_run(st["state0"],
                                             [(st["batch"], e, d) for e, d in dropout_steps],
                                             model={**SP_TRAIN_REMAT, "dropout": 0.1})}
    return {"ref": ref, "got": got, "single": single, "plan": plan, "one_plan": one_plan,
            "moe": (moe_x, moe_mask, moe_states), "state0": state0, "ring": ring}


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
    ranks = [r[shape, n] for r in par["got"]["sp_model"]]
    assert_sp_forward(ranks, par["single"]["sp"][n], par["ref"]["sp_forward"][n], shape, n)


@pytest.mark.parametrize("n", SP_BUCKETS)
@pytest.mark.parametrize("shape", SP_WIN_SHAPES)
def test_sp_windowed_forward_matches_jax_and_one_process(par, shape, n):
    """DGDM-Large's two windows (W 8, banded graph layers and windowed
    spatial attention) on the tiny Base over (data, model) ``shape``, with
    the bounds above; JAX's forward is ``DGDMModel.apply`` on
    ``shard_graph_nodes(batch, mesh)`` over a mesh of that shape. The
    route and the band are the whole bucket's: at bucket 32 the graph has 4
    windows, so over a model axis of 4 a rank holds one window, both its
    neighbours come from other ranks and rank 0's previous one is rank 3's
    last (a rule decided on the block's 8 rows would go dense)."""
    model = DGDMModel(**SP_WIN)
    assert model.spatial_attention.route(n) == "window" and band_eligible(n, 8)
    job = "sp_win_2" if shape == (1, 2) else "sp_win_4"
    ranks = [r[shape, n] for r in par["got"][job] if r is not None]
    one = par["single"]["sp_win"][n]
    assert_sp_forward(ranks, one, par["ref"]["win_forward"][shape, n], shape, n)
    # the windows change the model: its logits are not those without them
    plain = par["single"]["sp"][n]["classification_logits"]
    assert float((one["classification_logits"] - plain).abs().max()) > 1e-3


def assert_sp_forward(ranks, one, jax_ref, shape, n):
    """Each rank's ``sp_forward`` outputs against JAX's (logits and graph
    embedding 1e-4) and one process's (1e-5, node embeddings its block,
    selections equal), the heads equal on every rank of a model line."""
    dp, tp = shape
    rows, n_loc = SP_GRAPHS // dp, n // tp
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


@pytest.mark.parametrize("shape", SP_WIN_SHAPES)
def test_sp_forward_returns_the_attention_rows_of_one_process(par, shape):
    """``return_attention=True`` on the windowed tiny Base, bucket 32: each
    rank returns its rows of the banded encoder layers' edge attentions
    [b, n, K, H], of the spatial attention's dense weights [b, H, n, N]
    (weights asked take the dense route, the band stays) and of the
    readout's attention weights [b, n]; concatenated over the model line's
    ranks they are one process's within 1e-5, and the logits stay within
    1e-5."""
    dp, tp = shape
    rows = SP_GRAPHS // dp
    one = par["single"]["sp_win"]["attention"]
    job = "sp_win_2" if shape == (1, 2) else "sp_win_4"
    ranks = [r[shape, "attention"] for r in par["got"][job] if r is not None]
    assert len(one["edge_attentions"]) == SP_WIN["graph_layers"]
    for d in range(dp):
        line = ranks[d * tp:(d + 1) * tp]
        b = slice(d * rows, (d + 1) * rows)
        got = {"spatial_attention": torch.cat([r["spatial_attention"] for r in line], 2),
               "attention_weights": torch.cat([r["attention_weights"] for r in line], 1),
               **{f"edge_attentions {i}": torch.cat([r["edge_attentions"][i] for r in line], 1)
                  for i in range(len(one["edge_attentions"]))}}
        want = {"spatial_attention": one["spatial_attention"],
                "attention_weights": one["attention_weights"],
                **{f"edge_attentions {i}": a for i, a in enumerate(one["edge_attentions"])}}
        for key, w in want.items():
            assert got[key].shape == w[b].shape, key
            np.testing.assert_allclose(got[key].numpy(), w[b].numpy(), atol=1e-5, rtol=0,
                                       err_msg=key)
        for r in line:
            np.testing.assert_allclose(r["classification_logits"].numpy(),
                                       one["classification_logits"][b].numpy(), atol=1e-5,
                                       rtol=0)


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
    """Flash attention raises naming ROADMAP item 12 (12b: beyond the
    reference, whose model takes no flash route). The rest work over a
    model axis of 1, within 1e-6 of the model: ``mode="pretrain"`` gives the
    model's diffusion loss on the same draws, ``deterministic=False`` the
    model's dropout from the same generator state, ``return_attention=True``
    the model's edge, spatial and readout attention, and each of
    DGDM-Large's windows (W 8 on the bucket's 4 windows) the model's banded
    layers or windowed attention, with dropout in pretrain mode (the window
    route's masks over the windows, a rank's ring shift the identity, as
    ``torch.roll`` wraps the graph). The MoE (4 experts, top-2, the batch's
    one routing group) in pretrain mode with dropout gives the model's aux
    loss and outputs, the expert dropout included; ``use_remat`` under a
    gradient, in pretrain mode with dropout, the model's outputs and, of
    their sum, the parameters' gradients (the recompute replays the
    dropout)."""
    kw = {"moe": {"moe_experts": 4, "moe_top_k": 2, "dropout": 0.1},
          "spatial_window": {"spatial_window": 8},
          "graph_window": {"graph_window": 8}, "remat": {"use_remat": True, "dropout": 0.1},
          "dropout": {"dropout": 0.1}}.get(option, {})
    if option in ("spatial_window", "graph_window"):
        kw["dropout"] = 0.1
    model = init_parameters(DGDMModel(**{**SP_MODEL, **kw}), torch.Generator().manual_seed(5))
    if option == "use_flash":
        model.spatial_attention.use_flash = True
    g = to_torch_graph(sp_batch(32))
    mesh = Mesh(("data", "model"), (1, 1))
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=1)
    if option == "use_flash":
        with pytest.raises(NotImplementedError, match="item 12"):
            sp_forward(model, g, plan, mesh)
        return
    pretrain = ({"mode": "pretrain", "deterministic": False},
                ("diffusion_loss", "node_embeddings", "classification_logits"))
    call, keys = {
        "mode": ({"mode": "pretrain", "deterministic": False},
                 ("diffusion_loss", "classification_logits")),
        "dropout": ({"mode": "finetune", "deterministic": False},
                    ("node_embeddings", "classification_logits")),
        "return_attention": ({"return_attention": True},
                             ("edge_attentions", "spatial_attention", "attention_weights",
                              "classification_logits")),
        "moe": (pretrain[0], pretrain[1] + ("moe_aux_loss",)),
    }.get(option, pretrain)
    if option == "spatial_window":
        assert model.spatial_attention.route(32, deterministic=False) == "window"
    outs, grads = [], []
    for fn in (lambda **c: sp_forward(model, g, plan, mesh, **c), lambda **c: model(g, **c)):
        with torch.set_grad_enabled(option == "remat"):
            out = fn(generator=torch.Generator().manual_seed(9), **call)
            if option == "remat":
                model.zero_grad(set_to_none=True)
                sum(out[k].float().sum() for k in keys).backward()
                grads.append({k: p.grad for k, p in model.named_parameters()
                              if p.grad is not None})
        outs.append(out)
    for key in keys:
        torch.testing.assert_close(outs[0][key], outs[1][key], atol=1e-6, rtol=1e-6)
    if option == "remat":
        assert set(grads[0]) == set(grads[1])
        for k, v in grads[1].items():
            torch.testing.assert_close(grads[0][k], v, atol=1e-5, rtol=1e-5, msg=k)


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


@pytest.mark.parametrize("n,tp,window", [(48, 4, 8), (48, 2, 16)])
def test_sp_forward_rejects_a_block_that_is_not_whole_windows(n, tp, window):
    """The window route is the whole bucket's (48 nodes: 6 windows of 8, 3
    of 16); a block of 12 or 24 rows is not a whole number of them, and the
    call raises before any exchange, naming the shape. Every level divides
    by the model axis."""
    g = to_torch_graph(j_batch([make_synthetic_graph(seed=0, n_nodes=n, n_real=n - 4,
                                                     feat_dim=16)] * 2))
    mesh = Mesh(("data", "model"), (1, tp), lines={"model": Axis("model", tp, 0)})
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=tp)
    model = DGDMModel(**{**SP_MODEL, "spatial_window": window})
    assert all(size % tp == 0 for size in level_sizes(model, n))
    assert model.spatial_attention.route(n) == "window"
    with pytest.raises(ValueError, match=f"block of {n // tp} rows of {n}: the block is not "
                                         f"a whole number of windows of {window}"):
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
def test_sp_windowed_training_matches_jax_and_one_process(par, shape):
    """The steps of the JAX-draws test below on the model with both windows
    (W 8 on 4 windows of the 32 bucket, 93.5% of the edges in band: the band
    prunes the rest), from the same state and draws, with the same bounds:
    against one port process and JAX ``training_step(shard_graph_nodes(
    batch, mesh), prepared=True)`` of the windowed model on a (2, 2)
    mesh."""
    name = "12" if shape == "(1, 2)" else "22"
    got = next(r for r in par["got"][f"sp_win{name}_jax"] if r is not None)
    jref = par["ref"]["sp_train"]
    assert_sp_training_matches(got, par["single"]["sp_win_jax"], jref["win_jax"],
                               jref["win_jax_params"], f"windowed sp {shape}")
    # the windows change the steps: their losses are not the plain model's
    assert abs(got["metrics"][0]["loss"] - jref["jax"][0]["loss"]) > 1e-5


@pytest.mark.parametrize("shape", ["(1, 2)", "(1, 4)"])
def test_sp_windowed_training_with_dropout_equals_one_process(par, shape):
    """The windowed model's steps at dropout 0.1 from the generator (on the
    spatial attention: the whole [b, nb, H, W, 3W] draw of one process, a
    rank keeping its windows' rows), 3 pretrain and 1 finetune, against one
    process on the whole batch with the bounds of the dropout test below;
    at (1, 4) each rank holds one window of the 32 bucket."""
    name, tp = {"(1, 2)": ("12", 2), "(1, 4)": ("14", 4)}[shape]
    ranks = [r for r in par["got"][f"sp_win{name}_dropout"] if r is not None]
    assert len(ranks) == tp
    ref = par["single"]["sp_win_dropout"]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    _metrics_close(ranks[0]["metrics"], ref["metrics"], f"windowed sp {shape} dropout")
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], ranks[0]["params"][k]) for k in r["params"])
    params = {k: v for k, v in ranks[0]["params"].items() if k in ref["params"]}
    assert_params_close(params, ref["params"], len(SP_TRAIN_EPOCHS) * CFG["learning_rate"],
                        f"windowed sp {shape} dropout")


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
    jref = par["ref"]["sp_train"]
    assert_sp_training_matches(got, par["single"]["sp_train_jax"], jref["jax"],
                               jref["jax_params"], f"sp {shape}")


def assert_sp_training_matches(got, one, jax_metrics, jax_params, what,
                               jax_key_biases_to_lr=False):
    """A rank's node-sharded steps against one port process (metrics 1e-5 of
    max(1, |x|), parameters 1e-5, the key biases to the summed learning
    rate) and the JAX steps (each loss rel 2e-4, parameters atol 2e-4; with
    ``jax_key_biases_to_lr`` the key biases, whose true gradient is 0, to the
    summed learning rate there too)."""
    assert len(got["metrics"]) == len(one["metrics"]) == len(jax_metrics)
    _metrics_close(got["metrics"], one["metrics"], what)
    params = {k: v for k, v in got["params"].items() if k in one["params"]}
    lr_sum = len(one["metrics"]) * CFG["learning_rate"]
    assert_params_close(params, one["params"], lr_sum, what)
    for a, b in zip(got["metrics"], jax_metrics):
        assert set(a) == set(b)
        assert a["loss"] == pytest.approx(float(b["loss"]), rel=2e-4)
    assert set(params) == set(jax_params)
    for key, value in jax_params.items():
        loose = jax_key_biases_to_lr and key.endswith(SHIFT_INVARIANT_BIASES)
        np.testing.assert_allclose(params[key].numpy(), value.numpy(),
                                   atol=lr_sum if loose else 2e-4, err_msg=key)


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


@pytest.mark.parametrize("offset", RING_OFFSETS)
def test_ring_shift_gradient_equals_torch_roll(par, offset):
    """``mesh.shift`` over a model line of 4 ranks, each holding 2 of 8 rows:
    what the ranks receive, concatenated, is ``torch.roll`` of the whole
    tensor by ``offset`` blocks (the last rank's rows wrap to the first),
    and the gradient of ``sum(y * w)`` each rank gets for its block is its
    block of the gradient through ``torch.roll`` (sent back by
    ``-offset``). On a line of one rank the shift is the identity."""
    x, w = (t.clone() for t in par["ring"])
    ranks = [r[offset] for r in par["got"]["ring_shift"]]
    leaf = x.clone().requires_grad_()
    y = torch.roll(leaf, 2 * offset, 1)
    (y * w).sum().backward()
    assert torch.equal(torch.cat([r[0] for r in ranks], 1), y.detach())
    assert torch.equal(torch.cat([r[1] for r in ranks], 1), leaf.grad)
    assert shift(x, Axis("model"), offset) is x


def test_a_one_rank_process_group_keeps_the_data_parallel_path(par):
    """A world of one rank (one NCCL rank on one card, as chip_smoke's DP
    phase runs it): the data line is the world group, the trainer takes the
    data-parallel path, and its step equals one process's (the draws at the
    global shape are the single process's)."""
    got = par["got"]["one_rank"][0]
    assert got["group"] and got["dp"]
    _metrics_close([got["metrics"]], par["single"]["one_rank"]["metrics"], "one rank")
    assert all(r is None for r in par["got"]["one_rank"][1:])


@pytest.mark.parametrize("batch", sorted(SP_MOE_BATCHES))
@pytest.mark.parametrize("top_k", sorted(SP_MOE_TOPK))
@pytest.mark.parametrize("shape", SP_MOE_SHAPES)
def test_sp_moe_forward_matches_jax_and_one_process(par, shape, top_k, batch):
    """The tiny Base with 4 experts (no U-Net) over (data, model) ``shape``, in the
    JAX model's routing groups of 1024 tokens (``SP_MOE_BATCHES``: a group
    inside a block, over the ranks of one graph, over graphs and ranks):
    each rank's logits and graph embedding within 1e-4 of JAX
    ``DGDMModel.apply`` on ``shard_graph_nodes`` of the batch (over the mesh
    of ``SP_MOE_JAX_MESH``) and 1e-5 of the port's one-process forward,
    equal on every rank of a line; its node embeddings its block of one
    process's (1e-5); its routing (the line's groups: every kept token and
    its slot) equal to one process's groups of its data rows; the aux loss
    equal on every rank of a line, its mean over the data ranks within 1e-6
    of one process's and 1e-4 of JAX's."""
    dp, tp = shape
    graphs, n = SP_MOE_BATCHES[batch]
    grp = routing_group(graphs * n, n, 1024)
    assert grp == 1024 and (graphs // dp * n) % grp == 0
    job = f"sp_moe_{top_k}_{2 if shape == (1, 2) else 4}"
    ranks = [r[shape, batch] for r in par["got"][job] if r is not None]
    one = par["single"]["sp_moe"][top_k, batch]
    jref = par["ref"]["sp_moe_forward"][top_k, batch]
    rows, n_loc = graphs // dp, n // tp
    groups = graphs * n // grp // dp
    for rank, out in enumerate(ranks):
        d, m = divmod(rank, tp)
        b = slice(d * rows, (d + 1) * rows)
        for key in ("classification_logits", "graph_embedding"):
            np.testing.assert_allclose(out[key].numpy(), jref[key][b], atol=1e-4, rtol=0,
                                       err_msg=key)
            np.testing.assert_allclose(out[key].numpy(), one[key][b].numpy(), atol=1e-5, rtol=0,
                                       err_msg=key)
        np.testing.assert_allclose(out["node_embeddings"].numpy(),
                                   one["node_embeddings"][b, m * n_loc:(m + 1) * n_loc].numpy(),
                                   atol=1e-5, rtol=0)
        assert torch.equal(out["moe_routing"],
                           one["moe_routing"][d * groups:(d + 1) * groups])
        line = ranks[d * tp]
        assert torch.equal(out["classification_logits"], line["classification_logits"])
        assert float(out["moe_aux_loss"]) == float(line["moe_aux_loss"])
    aux = sum(float(ranks[d * tp]["moe_aux_loss"]) for d in range(dp)) / dp
    assert aux == pytest.approx(float(one["moe_aux_loss"]), abs=1e-6)
    assert aux == pytest.approx(float(jref["moe_aux_loss"]), abs=1e-4)
    if top_k == "top2":     # capacity 0.5 drops choices: a dropped one codes -1
        assert bool((one["moe_routing"] < 0).any())


@pytest.mark.parametrize("shape", ["(1, 2)", "(1, 4)"])
def test_sp_moe_training_matches_jax_and_one_process(par, shape):
    """Node-sharded steps of the 2-layer tiny Base with 4 experts (top-2,
    capacity 0.5; the batch's 128 tokens one routing group over graphs and
    ranks) on the JAX draws, without dropout: against one port process and
    JAX ``training_step(shard_graph_nodes(batch, mesh), prepared=True)`` of
    the MoE model on a (2, 2) mesh, from the same parameters, with the
    bounds of the plain test, the key biases (true gradient 0: AdamW steps
    on rounding noise) held to the summed learning rate against JAX as
    against one process; the aux loss is among the metrics. A (2, 2)
    port mesh refuses this batch: its one group would straddle the data
    ranks (tests/test_torch_sp_train.py)."""
    name = "12" if shape == "(1, 2)" else "14"
    got = next(r for r in par["got"][f"sp_moe{name}_jax"] if r is not None)
    jref = par["ref"]["sp_train"]
    assert all("moe_aux_loss" in m for m in got["metrics"])
    assert_sp_training_matches(got, par["single"]["sp_moe_jax"], jref["moe_jax"],
                               jref["moe_jax_params"], f"sp moe {shape}",
                               jax_key_biases_to_lr=True)


@pytest.mark.parametrize("shape", ["(1, 2)", "(1, 4)"])
def test_sp_moe_training_with_dropout_equals_one_process(par, shape):
    """The MoE training model's steps at dropout 0.1 from the generator (the
    expert dropout drawn at one process's whole [E, g, C, H] shape on every
    rank), 3 pretrain and 1 finetune: every rank reports the same metrics,
    within 1e-5 of max(1, |x|) of one process's, and holds the same
    parameters, within 1e-5 (the key biases to the summed learning
    rate)."""
    tp = 2 if shape == "(1, 2)" else 4
    assert_sp_line_run(par, f"sp_moe1{tp}_dropout", tp, par["single"]["sp_moe_dropout"],
                       f"sp moe {shape} dropout")


def assert_sp_line_run(par, job, tp, ref, what):
    """A (1, tp) job's steps: the same metrics on every rank, within 1e-5 of
    max(1, |x|) of ``ref``'s, the same parameters on every rank, within 1e-5
    of ``ref``'s (the key biases to the summed learning rate)."""
    ranks = [r for r in par["got"][job] if r is not None]
    assert len(ranks) == tp and len(ranks[0]["metrics"]) == len(ref["metrics"])
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    _metrics_close(ranks[0]["metrics"], ref["metrics"], what)
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], ranks[0]["params"][k]) for k in r["params"])
    params = {k: v for k, v in ranks[0]["params"].items() if k in ref["params"]}
    assert_params_close(params, ref["params"], len(ref["metrics"]) * CFG["learning_rate"],
                        what)


@pytest.mark.parametrize("dropout", ["jax_draws", "dropout"])
@pytest.mark.parametrize("shape", ["(1, 2)", "(1, 4)"])
def test_sp_remat_training_matches_one_process(par, shape, dropout):
    """``use_remat`` under node sharding: each encoder layer checkpointed,
    its three halo exchanges run again in the recompute: the 3 pretrain
    steps on the JAX draws without dropout, and 3 pretrain and 1 finetune
    steps at dropout 0.1 from the generator (the recompute replays each
    layer's masks), against one
    port process with remat: every rank the same metrics, within 1e-5 of
    max(1, |x|), and the same parameters, within 1e-5 (the key biases to
    the summed learning rate)."""
    tp = 2 if shape == "(1, 2)" else 4
    kind = "jax" if dropout == "jax_draws" else "dropout"
    assert_sp_line_run(par, f"sp_remat1{tp}_{kind}", tp, par["single"][f"sp_remat_{kind}"],
                       f"sp remat {shape} {dropout}")


def test_sp_remat_training_matches_the_jax_remat_trainer(par):
    """The (1, 2) remat steps on the JAX draws (the 3 pretrain steps) against JAX
    ``training_step(shard_graph_nodes(batch, mesh), prepared=True)`` of the
    model with ``use_remat`` (``nn.remat`` of each encoder layer) on a
    (2, 2) mesh, from the same state: each loss within rel 2e-4, the
    parameters within atol 2e-4 (the key biases to the summed learning
    rate); and against one port process with remat (1e-5)."""
    got = next(r for r in par["got"]["sp_remat12_jax"] if r is not None)
    jref = par["ref"]["sp_train"]
    assert_sp_training_matches(got, par["single"]["sp_remat_jax"], jref["remat_jax"],
                               jref["remat_jax_params"], "sp remat (1, 2)",
                               jax_key_biases_to_lr=True)
