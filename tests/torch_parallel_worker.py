"""Jobs of the parallel-tier tests (tests/test_torch_parallel.py), run in the
ranks that ``torch_dp_worker.spawn_ranks`` starts: torch and the port only.
Each takes its spec and this process's rank and returns plain values and
tensors for the parent to hold against one process and the JAX package."""

from __future__ import annotations

import torch
import torch.distributed as dist


def _model(spec):
    from dgdm_histopath_torch.models.dgdm import DGDMModel

    model = DGDMModel(**spec["model"])
    model.load_state_dict(spec["state"])
    return model


def _tp_trainer(spec):
    from dgdm_histopath_torch.parallel import make_mesh
    from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

    mesh = make_mesh(axes=("data", "model"), shape=spec["shape"])
    trainer = DGDMTrainer(_model(spec), TrainerConfig(**spec["config"]), device="cpu",
                          mesh=mesh)
    trainer.init_state(seed=spec.get("seed", 0))
    return trainer


def tp_steps(spec, rank) -> dict:
    """Steps of a tensor-parallel trainer (``spec["shape"]`` over (data,
    model)): each step's metrics, the whole parameters after them, the
    layout, and this rank's parameter and AdamW bytes."""
    from dgdm_histopath_torch.parallel.tp import optimizer_bytes, param_bytes

    trainer = _tp_trainer(spec)
    metrics = [trainer.training_step(b, e, draws=d) for b, e, d in spec["steps"]]
    val = [{k: v.clone() for k, v in trainer.validation_step(b, e).items()}
           for b, e in spec.get("validate", [])]
    local = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    return {"metrics": metrics, "validation": val,
            "params": {k: v.clone() for k, v in trainer.model_state_dict().items()},
            "local": local, "layout": dict(trainer.model.tp_layout),
            "bytes": (param_bytes(trainer.params), optimizer_bytes(trainer.optimizer))}


def tp_checkpoint(spec, rank) -> dict:
    """A tensor-parallel step, the state saved by rank 0 (whole tensors) and
    restored into a fresh trainer on every rank: its shards and moments
    equal to the first trainer's, and the next step equal on both."""
    from dgdm_histopath_torch.training import CheckpointManager

    first = _tp_trainer(spec)
    batch, epoch = spec["batch"], spec["epoch"]
    first.training_step(batch, epoch)
    state = first.state_dict()
    if rank == 0:
        mgr = CheckpointManager(spec["dir"], save_top_k=1)
        mgr.save(state, step=1, metric=1.0)
        mgr.wait_until_finished()
    dist.barrier()
    restored = CheckpointManager(spec["dir"]).restore()
    second = _tp_trainer(spec)
    second.load_state_dict(restored)
    same = all(torch.equal(a, b) for a, b in zip(first.params, second.params))
    moments = [(first.optimizer.state[a], second.optimizer.state[b])
               for a, b in zip(first.params, second.params)]
    same_moments = all(torch.equal(x[k], y[k]) for x, y in moments for k in x)
    return {"same_params": same, "same_moments": same_moments,
            "sharded": len(first.model.tp_layout),
            "saved_shapes": {k: tuple(v.shape) for k, v in state["model"].items()},
            "moment_shapes": [tuple(s["exp_avg"].shape)
                              for s in state["optimizer"]["state"].values()],
            "next": [first.training_step(batch, epoch), second.training_step(batch, epoch)]}


def ep_block(spec, rank) -> dict:
    """The MoE block with its experts over (data, expert) ``spec["shape"]``:
    output, aux loss, routing and gradients of ``sum(out ** 2) + aux``."""
    from dgdm_histopath_torch.nn.moe import MoEFFN
    from dgdm_histopath_torch.parallel import make_mesh, place_experts

    mesh = make_mesh(axes=("data", "expert"), shape=spec["shape"])
    moe = MoEFFN(**spec["moe"])
    moe.load_state_dict(spec["state"])
    placed = place_experts(moe, mesh)
    x = spec["x"].clone().requires_grad_()
    out, aux = moe(x, spec["mask"])
    ((out ** 2).sum() + aux).backward()
    route = moe.route(x.detach(), spec["mask"])
    return {"placed": placed, "out": out.detach(), "aux": aux.detach(), "dx": x.grad,
            "grads": {k: p.grad.clone() for k, p in moe.named_parameters()},
            "kept": route["kept"], "index": mesh.axis("expert").index}


def halo(spec, rank) -> dict:
    """This rank's block of the halo gather (batched and unbatched) and of
    ``sp_graph_conv`` over a (1, tp) mesh."""
    from dgdm_histopath_torch.nn.graph_layers import GraphConvolution
    from dgdm_histopath_torch.parallel import (halo_gather, make_mesh, shard_graph_nodes,
                                               sp_graph_conv)

    tp = dist.get_world_size()
    mesh = make_mesh(axes=("data", "model"), shape=(1, tp))
    batch, plan = spec["batch"], spec["plan"]
    block = shard_graph_nodes(batch, mesh)
    conv = GraphConvolution(*spec["conv"])
    conv.load_state_dict(spec["conv_state"])
    with torch.no_grad():
        sp = sp_graph_conv(conv, block.x, block.nbr_idx, block.nbr_mask, plan, mesh,
                           edge_attr=block.edge_attr)
    one = spec["one"]
    lo = mesh.axis("model").index * (one.x.shape[0] // tp)
    return {"gather": halo_gather(block.x, plan, mesh), "sp": sp,
            "one": halo_gather(one.x[lo:lo + one.x.shape[0] // tp], spec["one_plan"], mesh),
            "block": block}


def sp_model(spec, rank) -> dict:
    """``sp_forward`` of the model on each (mesh shape, batch): this rank's
    outputs."""
    from dgdm_histopath_torch.parallel import make_mesh, shard_graph_nodes, sp_forward

    model = _model(spec).eval()
    out = {}
    for shape in spec["shapes"]:
        mesh = make_mesh(axes=("data", "model"), shape=shape)
        for n, batch in spec["batches"].items():
            block = shard_graph_nodes(batch, mesh)
            with torch.no_grad():        # inference, as a caller serving the model runs it
                out[shape, n] = sp_forward(model, block, spec["plans"][shape[1], n], mesh)
    return out


def sp_train(spec, rank) -> dict:
    """Steps of ``DGDMTrainer`` over the (data, model) ``spec["shape"]``: with
    ``spec["plan"]`` through ``training_step(block, epoch, prepared=True,
    plan=plan)`` on this rank's node block of ``spec["batch"]``, else the
    data-parallel steps of the whole batch. Each step's metrics and the whole
    parameters after them."""
    from dgdm_histopath_torch.parallel import shard_graph_nodes

    trainer = _tp_trainer(spec)
    batch, plan = spec["batch"], spec.get("plan")
    if plan is None:
        metrics = [trainer.training_step(batch, e, draws=d) for e, d in spec["steps"]]
    else:
        block = shard_graph_nodes(batch, trainer.mesh)
        metrics = [trainer.training_step(block, e, draws=d, prepared=True, plan=plan)
                   for e, d in spec["steps"]]
    return {"metrics": metrics,
            "params": {k: v.clone() for k, v in trainer.model_state_dict().items()}}


def halo_grads(spec, rank) -> dict:
    """This rank's gradients through ``halo_gather`` and ``sp_graph_conv`` over
    a (1, tp) mesh, of ``sum(out * cotangent)`` with its block of the whole
    cotangent: with respect to its block of x and, for the convolution, the
    parameters (this rank's part of their gradient)."""
    from dgdm_histopath_torch.nn.graph_layers import GraphConvolution
    from dgdm_histopath_torch.parallel import (halo_gather, make_mesh, shard_graph_nodes,
                                               sp_graph_conv)

    tp = dist.get_world_size()
    mesh = make_mesh(axes=("data", "model"), shape=(1, tp))
    batch, plan = spec["batch"], spec["plan"]
    block = shard_graph_nodes(batch, mesh)
    n_loc = plan.n_local
    mine = slice(mesh.axis("model").index * n_loc, (mesh.axis("model").index + 1) * n_loc)
    x = block.x.clone().requires_grad_()
    (halo_gather(x, plan, mesh) * spec["gather_cot"][:, mine]).sum().backward()
    conv = GraphConvolution(*spec["conv"])
    conv.load_state_dict(spec["conv_state"])
    xc = block.x.clone().requires_grad_()
    out = sp_graph_conv(conv, xc, block.nbr_idx, block.nbr_mask, plan, mesh,
                        edge_attr=block.edge_attr)
    (out * spec["conv_cot"][:, mine]).sum().backward()
    return {"gather_dx": x.grad, "conv_dx": xc.grad,
            "conv_grads": {k: p.grad.clone() for k, p in conv.named_parameters()}}


def pp(spec, rank) -> dict:
    """The GPipe encoder over (1, S) (data, pipe) for each variant: its output
    and the gradients of ``sum(out ** 2)`` this rank holds."""
    from dgdm_histopath_torch.models.encoders import GraphEncoder
    from dgdm_histopath_torch.parallel import make_mesh, pp_graph_encoder_apply

    mesh = make_mesh(axes=("data", "pipe"), shape=(1, dist.get_world_size()))
    out = {}
    for name, v in spec["variants"].items():
        enc = GraphEncoder(**v["encoder"])
        enc.load_state_dict(v["state"])
        g = v["graph"]
        y = pp_graph_encoder_apply(enc, mesh, g.x, g.nbr_idx, g.nbr_mask, g.node_mask,
                                   edge_attr=g.edge_attr if v["edges"] else None,
                                   num_micro=spec["num_micro"])
        (y ** 2).sum().backward()
        out[name] = {"out": y.detach(), "grads": {k: p.grad.clone() for k, p in
                                                  enc.named_parameters() if p.grad is not None}}
    return out


def collectives(spec, rank) -> dict:
    """The mesh's collectives on a (2, 2) mesh: each axis line's route, the
    autograd all_reduce / all_gather / all_to_all forward and backward, the
    raw shift and broadcast."""
    from dgdm_histopath_torch.parallel import all_gather, all_reduce, all_to_all, make_mesh

    mesh = make_mesh(axes=("data", "model"), shape=(2, 2))
    line = mesh.axis("model")
    x = torch.arange(4.0).view(2, 2).add(10 * rank).requires_grad_()
    w = torch.arange(8.0).view(2, 4)
    ys = {"reduce": all_reduce(x, line), "gather": all_gather(x, line, 1),
          "a2a": all_to_all(x, line, 0)}
    out = {}
    for name, y in ys.items():
        (g,) = torch.autograd.grad((y * w[:, :y.shape[1]]).sum(), x)
        out[name] = (y.detach(), g)
    return {**out, "route": line.route(x), "coords": (mesh.rank, line.index),
            "ranks": (mesh.axis("data").ranks, line.ranks),
            "shift": line.shift(torch.tensor([float(rank)]), 1),
            "broadcast": line.broadcast_(torch.tensor([float(rank)]), 1)}


def one_rank(spec, rank) -> dict:
    """A process group of one rank: the data mesh keeps the data-parallel
    path (its line is the world group), and a step runs on it."""
    from dgdm_histopath_torch.parallel import make_mesh
    from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

    mesh = make_mesh()
    trainer = DGDMTrainer(_model(spec), TrainerConfig(**spec["config"]), device="cpu",
                          mesh=mesh)
    trainer.init_state(0)
    return {"group": mesh.group is dist.group.WORLD, "dp": trainer._dp is not None,
            "metrics": trainer.training_step(spec["batch"], 0)}


def dryrun(spec, rank) -> dict:
    from dgdm_histopath_torch.parallel import dryrun_multichip

    return dryrun_multichip(dist.get_world_size(), "cpu")


JOBS = {"tp_steps": tp_steps, "tp_checkpoint": tp_checkpoint, "ep_block": ep_block,
        "halo": halo, "sp_model": sp_model, "sp_train": sp_train, "halo_grads": halo_grads,
        "pp": pp, "collectives": collectives, "one_rank": one_rank, "dryrun": dryrun}
