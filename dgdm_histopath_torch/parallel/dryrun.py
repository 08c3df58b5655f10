"""The multichip dry run of every parallel tier on tiny shapes (counterpart of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

Every rank of an initialized process group of ``n`` ranks calls
``dryrun_multichip(n, device)`` (the card unless ``device`` names
another); the shapes and skip rules are the JAX
run's: 64-d features, hidden (64, 32), 4 heads, graphs of 256 nodes (200
real, 8 neighbours), one a rank.

* data parallelism: a pretrain and a finetune step of the full model
  (spatial attention and the U-Net on, bf16 compute) over a ``data`` mesh;
* at ``n >= 4`` (even): tensor parallelism on ``(2, n/2)`` (some kernels
  sharded, a finetune step finite); node sharding (``shard_graph_nodes``)
  and the halo tier on the same mesh: ``halo_gather`` equal to the dense
  gather on every real slot of Morton-sorted graphs, ``sp_graph_conv``
  against ``GraphConvolution`` within 1e-5, and the whole model over
  node-sharded inputs (``sp_forward``, f32, where the JAX run checks its
  GSPMD forward's ``sp_logits_finite``): logits finite and within 1e-4 of
  the one-process forward;
* the windowed + banded model (W = 64, band-built graphs) under data
  parallelism;
* at ``n >= 4``: the GPipe encoder on ``(data 2, pipe n/2)`` against the
  sequential encoder within 1e-4, and the MoE block with its experts over
  ``(data 2, expert n/2)`` against the replicated block within 2e-5;
* at ``n >= 8``: one ``(2, 2, n/4)`` data x pipe x expert mesh running the
  pipelined encoder into the expert-parallel MoE: its loss against the
  sequential encoder and replicated block, gradients finite.

It prints one summary line on rank 0 and returns the numbers.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

FEAT, HIDDEN, HEADS, NODES, REAL, K = 64, (64, 32), 4, 256, 200, 8


def _graph(seed: int, band_window=None):
    from ..ops.graph import PaddedGraph
    from ..ops.knn import knn_euclidean

    rs = np.random.RandomState(seed)
    x = np.zeros((NODES, FEAT), np.float32)
    x[:REAL] = rs.randn(REAL, FEAT)
    pos = np.zeros((NODES, 2), np.float32)
    pos[:REAL] = rs.rand(REAL, 2)
    mask = np.zeros((NODES,), bool)
    mask[:REAL] = True
    pos_t, mask_t = torch.from_numpy(pos), torch.from_numpy(mask)
    idx, d, valid = knn_euclidean(pos_t, mask_t, K, band_window=band_window)
    edge_attr = torch.stack([d, torch.exp(-10.0 * d), torch.zeros_like(d)], -1)
    return PaddedGraph(x=torch.from_numpy(x), pos=pos_t, nbr_idx=idx, nbr_mask=valid,
                       edge_attr=edge_attr, node_mask=mask_t,
                       y=torch.tensor(seed % 2, dtype=torch.int32))


def _model(compute_dtype: str = "bfloat16", **kw):
    from ..models.dgdm import DGDMModel
    from ..nn.layers import init_parameters

    model = DGDMModel(node_features=FEAT, hidden_dims=HIDDEN, num_diffusion_steps=4,
                      attention_heads=HEADS, graph_layers=2, num_classes=2,
                      use_spatial_attention=True, use_hierarchical=True, pooling="attention",
                      compute_dtype=compute_dtype, **kw)
    return init_parameters(model, torch.Generator().manual_seed(0))


def _trainer(model, mesh, device):
    from ..training import DGDMTrainer, TrainerConfig

    trainer = DGDMTrainer(model, TrainerConfig(learning_rate=1e-3, warmup_steps=1,
                                               pretrain_epochs=1, steps_per_epoch=4),
                          device=device, mesh=mesh)
    trainer.init_state(0)
    return trainer


def _finite(metrics: Dict[str, float]) -> None:
    if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
            and metrics["grad_norm"] > 0.0):
        raise AssertionError(f"a step is not finite or moved nothing: {metrics}")


def _close(got: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    got, ref = got.detach().float(), ref.detach().float()
    err = float((got - ref).abs().max())
    if not err <= tol * max(1.0, float(ref.abs().max())):
        raise AssertionError(f"{what}: max error {err:.3e} over {tol}")
    return err


def dryrun_multichip(n_devices: int, device: Any = None) -> Dict[str, Any]:
    """Run every tier on ``n_devices`` ranks (the initialized process group
    must have exactly that many) on ``device`` (None: the card; raises
    without one); raises on the first failed check."""
    from ..nn.graph_layers import GraphConvolution
    from ..ops.graph import batch_graphs, gather_neighbors
    from .halo import build_halo_plan, halo_fraction, halo_gather, sp_graph_conv, spatial_sort
    from .mesh import MODEL_AXIS, make_mesh
    from .sp import shard_graph_nodes

    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} ranks, the process "
                         f"group has {world}")
    out: Dict[str, Any] = {}
    batch = batch_graphs([_graph(i) for i in range(n_devices)])

    mesh = make_mesh(axes=("data",))
    trainer = _trainer(_model(), mesh, device)
    pre = trainer.training_step(batch, epoch=0)
    fin = trainer.training_step(batch, epoch=1)
    _finite(pre)
    _finite(fin)
    out.update(pretrain_loss=pre["loss"], finetune_loss=fin["loss"],
               grad_norms=(pre["grad_norm"], fin["grad_norm"]))
    msgs = []

    even4 = n_devices >= 4 and n_devices % 2 == 0
    if even4:
        half = n_devices // 2
        mesh2 = make_mesh(axes=("data", MODEL_AXIS), shape=(2, half))
        tp = _trainer(_model(), mesh2, device)
        n_sharded = len(tp.model.tp_layout)
        if n_sharded == 0:
            raise AssertionError("the TP layout left every parameter replicated")
        m_tp = tp.training_step(batch, epoch=1)
        _finite(m_tp)
        out.update(tp_loss=m_tp["loss"], tp_sharded_params=n_sharded)
        msgs.append(f"tp_loss={m_tp['loss']:.4f} tp_sharded_params={n_sharded}")

        block = shard_graph_nodes(batch, mesh2)
        if block.x.shape[:2] != (n_devices // 2, NODES // half):
            raise AssertionError(f"node block {tuple(block.x.shape)}")
        srt = batch_graphs([spatial_sort(_graph(i)) for i in range(n_devices)])
        plan = build_halo_plan(srt.nbr_idx, srt.nbr_mask, tp=half)
        mine = shard_graph_nodes(srt, mesh2)
        xd = mine.x.to(device)
        halo = halo_gather(xd, plan, mesh2).cpu()
        dense = shard_graph_nodes(srt.replace(x=gather_neighbors(srt.x, srt.nbr_idx)
                                              .flatten(2)), mesh2).x.unflatten(-1, (K, FEAT))
        m = mine.nbr_mask[..., None]
        if not torch.equal(halo * m, dense * m):
            raise AssertionError("halo_gather differs from the dense gather on a real slot")
        conv = GraphConvolution(FEAT, 24, 3).to(device)
        with torch.no_grad():
            for p in conv.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(5)) * 0.1)
            ref = conv(srt.x.to(device), srt.nbr_idx.to(device), srt.nbr_mask.to(device),
                       srt.edge_attr.to(device))
            sp = sp_graph_conv(conv, xd, mine.nbr_idx.to(device), mine.nbr_mask.to(device),
                               plan, mesh2, edge_attr=mine.edge_attr.to(device))
        ref_mine = shard_graph_nodes(srt.replace(x=ref.cpu()), mesh2).x
        keep = mine.node_mask[..., None]
        sp_err = _close(sp.cpu() * keep, ref_mine * keep, 1e-5, "sp_graph_conv")
        frac = halo_fraction(srt.nbr_idx, srt.nbr_mask, half)
        sp_shape, sp_model_err = _sp_check(srt, mine, plan, mesh2, device)
        out.update(halo_size=plan.halo_size, halo_fraction=frac, sp_graph_conv_err=sp_err,
                   sp_forward_err=sp_model_err)
        msgs.append(f"sp_graph_conv_parity_ok(err={sp_err:.1e}) sp_logits_finite={sp_shape} "
                    f"sp_forward_parity_ok(err={sp_model_err:.1e}) "
                    f"halo_gather_parity_ok(H={plan.halo_size}, cross={frac:.3f})")
        del tp

    # windowed + banded under the data mesh, on band-built Morton graphs
    win = 64
    batch_w = batch_graphs([_banded(100 + i, win) for i in range(n_devices)])
    trainer_w = _trainer(_model(spatial_window=win, graph_window=win), mesh, device)
    m_win = trainer_w.training_step(batch_w, epoch=0)
    _finite(m_win)
    out["windowed_banded_loss"] = m_win["loss"]

    if even4:
        pp_msg, ep_msg = _pp_check(batch, n_devices, device), _ep_check(batch, n_devices, device)
        out.update(pp=pp_msg, ep=ep_msg)
        msgs += [pp_msg, ep_msg]
    if n_devices >= 8 and n_devices % 8 == 0:
        out["combined"] = _combined(batch, n_devices, device)
        msgs.append(out["combined"])
    line = (f"dryrun_multichip({n_devices}) OK: pretrain_loss={pre['loss']:.4f} "
            f"finetune_loss={fin['loss']:.4f} grad_norms=({pre['grad_norm']:.4f}, "
            f"{fin['grad_norm']:.4f}) windowed_banded_loss={m_win['loss']:.4f} "
            + " ".join(msgs or ["tp=skipped pp=skipped ep=skipped"]))
    if n_devices < 8:
        line += " combined=skipped"
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line, flush=True)
    out["line"] = line
    return out


def _sp_check(batch, block, plan, mesh, device) -> tuple:
    """The f32 model over this rank's node block (``sp_forward``) against its
    one-process forward: logits finite and within 1e-4. Returns (the
    logits' shape, the error)."""
    from .sp import sp_forward

    model = _model("float32").to(device).eval()
    with torch.no_grad():
        ref = model(batch.to(device))["classification_logits"]
    got = sp_forward(model, block.to(device), plan, mesh)["classification_logits"]
    if not torch.isfinite(got).all():
        raise AssertionError("sp_forward logits are not finite")
    rows = got.shape[0]
    d = mesh.rank
    return tuple(got.shape), _close(got, ref[d * rows:(d + 1) * rows], 1e-4, "sp_forward")


def _banded(seed: int, win: int):
    """A Morton-sorted graph whose kNN edges lie in the ±1-block band."""
    from ..ops.knn import knn_euclidean
    from .halo import spatial_sort

    g = spatial_sort(_graph(seed))
    idx, d, valid = knn_euclidean(g.pos, g.node_mask, K, band_window=win)
    edge_attr = torch.stack([d, torch.exp(-10.0 * d), torch.zeros_like(d)], -1)
    return g.replace(nbr_idx=idx, nbr_mask=valid, edge_attr=edge_attr)


def _encoder(layers: int, seed: int, device):
    from ..models.encoders import GraphEncoder
    from ..nn.layers import init_parameters

    enc = GraphEncoder(FEAT, 64, num_layers=layers, num_heads=HEADS, edge_dim=3)
    return init_parameters(enc, torch.Generator().manual_seed(seed)).to(device)


def _moe(experts: int, seed: int, device):
    from ..nn.layers import init_parameters
    from ..nn.moe import MoEFFN

    moe = MoEFFN(64, 128, num_experts=experts, top_k=2, dtype=torch.float32)
    return init_parameters(moe, torch.Generator().manual_seed(seed)).to(device)


def _on(batch, device):
    return [t.to(device) for t in (batch.x, batch.nbr_idx, batch.nbr_mask, batch.node_mask,
                                   batch.edge_attr)]


def _pp_check(batch, n: int, device) -> str:
    from .mesh import make_mesh
    from .pp import PIPE_AXIS, pp_graph_encoder_apply

    stages = n // 2
    mesh = make_mesh(axes=("data", PIPE_AXIS), shape=(2, stages))
    enc = _encoder(stages, 7, device)
    x, idx, msk, node, ea = _on(batch, device)
    with torch.no_grad():
        ref = enc(x, idx, msk, node, edge_attr=ea)["embeddings"]
        got = pp_graph_encoder_apply(enc, mesh, x, idx, msk, node, edge_attr=ea, num_micro=2,
                                     data_axis="data")
    rows = ref.shape[0] // 2
    d = mesh.axis("data").index
    _close(got, ref[d * rows:(d + 1) * rows], 1e-4, "pipelined encoder")
    return f"pp_parity_ok(stages={stages})"


def _ep_check(batch, n: int, device) -> str:
    from .ep import EXPERT_AXIS, count_expert_sharded, ep_param_specs, place_experts
    from .mesh import make_mesh
    from .tp import nest

    n_ep = n // 2
    mesh = make_mesh(axes=("data", EXPERT_AXIS), shape=(2, n_ep))
    ref_moe, moe = _moe(2 * n_ep, 9, device), _moe(2 * n_ep, 9, device)
    tree = nest({f"params/{k}": v for k, v in ref_moe.named_parameters()})
    sharded = count_expert_sharded(ep_param_specs(tree, mesh))
    if sharded != 4 or place_experts(moe, mesh) != 4:
        raise AssertionError(f"{sharded} expert leaves sharded, expected 4")
    xm = batch.x[..., :64].float().to(device)
    mask = batch.node_mask.to(device)
    ref_out, ref_aux = ref_moe(xm, mask)
    out, aux = moe(xm, mask)
    _close(out, ref_out, 2e-5, "expert-parallel MoE")
    _close(aux, ref_aux, 2e-5, "expert-parallel aux loss")
    (out ** 2).sum().backward()
    gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in moe.parameters()
                           if p.grad is not None))
    if not (torch.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"expert-parallel gradient norm {float(gnorm)}")
    return f"ep_parity_ok(experts={2 * n_ep}/ep={n_ep})"


def _combined(batch, n: int, device) -> str:
    from .ep import EXPERT_AXIS, place_experts
    from .mesh import make_mesh
    from .pp import PIPE_AXIS, pp_graph_encoder_apply

    mesh = make_mesh(axes=("data", PIPE_AXIS, EXPERT_AXIS), shape=(2, 2, n // 4))
    enc = _encoder(2, 11, device)
    ref_moe, moe = _moe(2 * (n // 4), 12, device), _moe(2 * (n // 4), 12, device)
    place_experts(moe, mesh)
    x, idx, msk, node, ea = _on(batch, device)
    rows = x.shape[0] // 2
    d = mesh.axis("data").index
    mine = node[d * rows:(d + 1) * rows]
    weight = mine[..., None].float()

    h = pp_graph_encoder_apply(enc, mesh, x, idx, msk, node, edge_attr=ea, num_micro=2,
                               data_axis="data")
    y, _aux = moe(h, mine)
    loss = ((y * weight) ** 2).sum() / weight.sum()
    with torch.no_grad():
        h_ref = enc(x, idx, msk, node, edge_attr=ea)["embeddings"][d * rows:(d + 1) * rows]
        y_ref, _ = ref_moe(h_ref, mine)
        loss_ref = ((y_ref * weight) ** 2).sum() / weight.sum()
    _close(loss.detach(), loss_ref, 1e-4, "combined mesh loss")
    loss.backward()
    g = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in list(enc.parameters())
                       + list(moe.parameters()) if p.grad is not None))
    if not (torch.isfinite(g) and g > 0):
        raise AssertionError(f"combined mesh gradient norm {float(g)}")
    return (f"combined_mesh_parity_ok(2x2x{n // 4} dp*pp*ep, "
            f"loss={float(loss.detach()):.5f})")


__all__ = ["dryrun_multichip"]
