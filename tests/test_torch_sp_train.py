"""The pieces of training over node-sharded inputs that run in one process,
on the CPU (the multi-rank steps against one process and JAX are in
tests/test_torch_parallel.py, in its one spawn of 4 ranks).

* The rectangular gather backwards (a table of M rows read by N rows of K
  slots, M < N, M = N and M > N, with slots outside [0, M)): ``gather_rows``
  and ``weighted_gather_sum`` through autograd, and their plain backward
  functions, within 1e-6 of the f64 autograd of a dense gather.
* The transposed list over M rows, equal to the bit to a stable sort written
  out in numpy; the square call unchanged.
* Dropout keyed to nodes (``nn.layers.NodeRows``): a node block takes the
  block of one process's mask, drawn from the same generator state; rows
  named by node ids take those nodes' masks, so a swap of two rows swaps
  their masks with them; the U-Net's pooled levels key theirs so.
* ``sp_forward`` over a model axis of 1 with the transposed lists built on
  the CPU: the parameters' gradients within 1e-5 of the model's.
* ``training_step`` refuses a plan without a prepared block.

The inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.layers import NodeRows, dropout, init_parameters
from dgdm_histopath_torch.ops.graph import PaddedGraph
from dgdm_histopath_torch.ops.kernels import neighbor_transpose as nt
from dgdm_histopath_torch.ops.kernels.gather_agg import (
    weighted_gather_sum,
    weighted_gather_sum_bwd_plain,
)
from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_bwd_plain
from dgdm_histopath_torch.parallel import halo, sp_forward
from dgdm_histopath_torch.parallel.mesh import Mesh
from dgdm_histopath_torch.training import DGDMTrainer, TrainerConfig

B, N, K, F = 3, 12, 4, 5
ROWS = {"M<N": 7, "M=N": 12, "M>N": 19}


def inputs(m: int, seed: int = 0):
    """src [B, M, F] f32, idx [B, N, K] int32 with about a fifth of the
    slots outside [0, M) (-1, M, M + 3), w [B, N, K] and a cotangent."""
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, m, (B, N, K))
    out = rs.rand(B, N, K) < 0.2
    idx[out] = rs.choice([-1, m, m + 3], out.sum())
    src = rs.randn(B, m, F).astype(np.float32)
    w = rs.rand(B, N, K).astype(np.float32)
    return (torch.from_numpy(src), torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(w))


def dense_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    m = src.shape[1]
    valid = (idx >= 0) & (idx < m)
    rows = torch.stack([src[b][idx[b].clamp(0, m - 1).long()] for b in range(src.shape[0])])
    return rows * valid[..., None].to(src.dtype)


@pytest.mark.parametrize("case", sorted(ROWS))
def test_rectangular_gather_rows_backward_matches_f64_autograd(case):
    m = ROWS[case]
    src, idx, _ = inputs(m)
    cot = torch.from_numpy(np.random.RandomState(1).randn(B, N, K, F).astype(np.float32))
    leaf = src.clone().requires_grad_()
    (gather_rows(leaf, idx) * cot).sum().backward()
    ref = src.double().requires_grad_()
    (dense_gather(ref, idx) * cot.double()).sum().backward()
    assert leaf.grad.shape == (B, m, F)
    np.testing.assert_allclose(leaf.grad.double().numpy(), ref.grad.numpy(), atol=1e-6, rtol=0)
    direct = gather_rows_bwd_plain(idx, cot, m=m)
    assert torch.equal(direct, leaf.grad)
    assert torch.equal(gather_rows_bwd_plain(idx, cot, nt.neighbor_transpose(idx, m), m),
                       direct)


@pytest.mark.parametrize("case", sorted(ROWS))
def test_rectangular_weighted_gather_sum_backward_matches_f64_autograd(case):
    m = ROWS[case]
    src, idx, w = inputs(m, seed=2)
    cot = torch.from_numpy(np.random.RandomState(3).randn(B, N, F).astype(np.float32))
    h, lw = src.clone().requires_grad_(), w.clone().requires_grad_()
    (weighted_gather_sum(h, idx, lw) * cot).sum().backward()
    rh, rw = src.double().requires_grad_(), w.double().requires_grad_()
    ((dense_gather(rh, idx) * rw[..., None]).sum(-2) * cot.double()).sum().backward()
    assert h.grad.shape == (B, m, F) and lw.grad.shape == (B, N, K)
    np.testing.assert_allclose(h.grad.double().numpy(), rh.grad.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lw.grad.double().numpy(), rw.grad.numpy(), atol=1e-6, rtol=0)
    dh, dw = weighted_gather_sum_bwd_plain(cot, src, idx, w)
    assert torch.equal(dh, h.grad) and torch.equal(dw, lw.grad)


def stable_sort_list(idx: np.ndarray, m: int):
    """The transposed list written out: row r's slots in increasing order."""
    b, n, k = idx.shape
    offsets = np.zeros((b, m + 1), np.int32)
    slots = np.full((b, n * k), -1, np.int32)
    for g in range(b):
        flat = idx[g].reshape(-1)
        pos = 0
        for r in range(m):
            mine = np.nonzero(flat == r)[0]
            slots[g, pos:pos + mine.size] = mine
            pos += mine.size
            offsets[g, r + 1] = pos
    return offsets, slots


@pytest.mark.parametrize("case", sorted(ROWS))
def test_transposed_list_over_m_rows_equals_a_stable_sort(case):
    """offsets [B, M + 1], slots [B, N·K]: every slot in [0, M) once, in its
    row's group in increasing order, the others dropped (a -1 tail)."""
    m = ROWS[case]
    _, idx, _ = inputs(m, seed=4)
    got = nt.neighbor_transpose(idx, m)
    offsets, slots = stable_sort_list(idx.numpy(), m)
    assert np.array_equal(got.offsets.numpy(), offsets)
    assert np.array_equal(got.slots.numpy(), slots)
    nt.check_transpose(got, idx, m)
    assert got.offsets[:, -1].tolist() == ((idx >= 0) & (idx < m)).sum((1, 2)).tolist()


def test_the_square_list_is_unchanged_and_a_wrong_m_is_refused():
    """Without ``m`` the list is the one over N rows, as before; a list
    checked against another row count raises."""
    _, idx, _ = inputs(N, seed=5)
    square = nt.neighbor_transpose(idx)
    assert all(torch.equal(a, b) for a, b in zip(square, nt.neighbor_transpose(idx, N)))
    offsets, slots = stable_sort_list(idx.numpy(), N)
    assert np.array_equal(square.offsets.numpy(), offsets)
    assert np.array_equal(square.slots.numpy(), slots)
    with pytest.raises(ValueError, match="over 13 rows"):
        nt.check_transpose(square, idx, N + 1)
    with pytest.raises(ValueError, match=r"\(3, 12, 4\) over 13 rows"):
        gather_rows(torch.zeros(B, N + 1, F), idx, square)


@pytest.mark.parametrize("shape,dim", [((2, 6, 8), -2), ((2, 6, 4, 3), -3),
                                       ((2, 3, 6, 12), -2)])
def test_dropout_over_a_node_block_keeps_the_whole_draw(shape, dim):
    """Features [b, n, F], per-edge attention [b, n, K, H] and spatial
    attention weights [b, H, n, N]: block 1 of 2 (``NodeRows(2n, lo=n)``)
    drops what one process drops in those rows, and leaves the generator
    where one process leaves it."""
    x = torch.from_numpy(np.random.RandomState(6).rand(*shape).astype(np.float32)) + 1.0
    whole_shape = list(shape)
    whole_shape[dim] *= 2
    whole = torch.ones(whole_shape)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    want = dropout(whole, 0.5, g1).narrow(dim, shape[dim], shape[dim]) * x
    got = dropout(x, 0.5, g2, NodeRows(2 * shape[dim], lo=shape[dim]), node_dim=dim)
    assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert 0 < int((got == 0).sum()) < got.numel()


@pytest.mark.parametrize("shape,dim", [((2, 6, 8), -2), ((2, 6, 4, 3), -3)])
def test_dropout_rows_named_by_node_ids_take_their_nodes_masks(shape, dim):
    """Rows [b, n, ...] that hold the nodes ``ids`` of a graph of 2n nodes
    take those nodes' rows of one process's mask over the whole graph; rows
    that swap nodes swap masks (the pooled levels' case: two nodes whose
    scores tie to rounding take each other's slots); ids that do not index
    x's leading axes raise."""
    rs = np.random.RandomState(9)
    n = shape[dim]
    ids = torch.from_numpy(np.stack([rs.permutation(2 * n)[:n] for _ in range(shape[0])]))
    x = torch.ones(shape)
    whole_shape = list(shape)
    whole_shape[dim] = 2 * n
    g = [torch.Generator().manual_seed(10) for _ in range(3)]
    whole = dropout(torch.ones(whole_shape), 0.5, g[0])
    got = dropout(x, 0.5, g[1], NodeRows(2 * n, ids=ids), node_dim=dim)
    for b in range(shape[0]):
        assert torch.equal(got[b], whole[b][ids[b]])
    swapped = ids.clone()
    swapped[:, [0, 1]] = ids[:, [1, 0]]
    other = dropout(x, 0.5, g[2], NodeRows(2 * n, ids=swapped), node_dim=dim)
    assert torch.equal(other[:, [1, 0]], got[:, :2]) and torch.equal(other[:, 2:], got[:, 2:])
    assert torch.equal(g[0].get_state(), g[1].get_state())
    with pytest.raises(ValueError, match="do not index"):
        dropout(x, 0.5, g[1], NodeRows(2 * n, ids=ids[:, :-1]), node_dim=dim)


def test_the_unet_keys_a_pooled_levels_masks_to_its_nodes(monkeypatch):
    """``GraphUNet`` at dropout 0.5: every dropout at a pooled level gets its
    rows' nodes of the first level (the composed selections), and a run in
    which the first pooling puts its two top nodes in each other's slots (as
    two nodes whose scores tie to rounding may) gives the same output within
    1e-6; with masks in slot order (the check that the test can see a swap)
    it does not."""
    from dgdm_histopath_torch.nn import graph_layers
    from dgdm_histopath_torch.nn.graph_layers import GraphUNet
    from dgdm_histopath_torch.ops.graph import real_edge_index

    g = tiny_graph(graphs=1)
    unet = init_parameters(GraphUNet(16, 16, depth=2, num_heads=4, edge_dim=3, dropout=0.5),
                           torch.Generator().manual_seed(11))
    nbr_idx = real_edge_index(g.nbr_idx, g.nbr_mask & g.node_mask[..., None])
    real_dropout, real_compact = graph_layers.dropout, graph_layers.compact_top_k_nodes

    def run():
        with torch.no_grad():
            return unet(g.x, nbr_idx, g.nbr_mask, g.node_mask, g.edge_attr,
                        deterministic=False, generator=torch.Generator().manual_seed(12))

    seen = []

    def spy(x, rate, generator=None, rows=None, node_dim=-2):
        seen.append(None if rows is None else (rows.n, tuple(rows.ids.shape)))
        return real_dropout(x, rate, generator, rows, node_dim)

    monkeypatch.setattr(graph_layers, "dropout", spy)
    out = run()
    # down0, down1, the bottleneck, up1, up0: two dropouts each
    level1, level2 = (32, (1, 16)), (32, (1, 8))
    assert seen == [None] * 2 + [level1] * 2 + [level2] * 2 + [level1] * 2 + [None] * 2

    def swap_first_two(*args, **kwargs):
        c = real_compact(*args, **kwargs)
        if c["x"].shape[-2] != 16:
            return c
        perm = torch.arange(16)
        perm[[0, 1]] = perm[[1, 0]]
        assert bool(c["node_mask"][:, :2].all())
        out = {k: None if v is None else v[:, perm] for k, v in c.items()}
        out["nbr_idx"] = torch.where(out["nbr_mask"], perm[out["nbr_idx"].long()],
                                     out["nbr_idx"]).to(c["nbr_idx"].dtype)
        return out

    monkeypatch.setattr(graph_layers, "dropout", real_dropout)
    monkeypatch.setattr(graph_layers, "compact_top_k_nodes", swap_first_two)
    np.testing.assert_allclose(run().numpy(), out.numpy(), atol=1e-6, rtol=0)

    def slot_order(x, rate, generator=None, rows=None, node_dim=-2):
        return real_dropout(x, rate, generator, None, node_dim)

    monkeypatch.setattr(graph_layers, "dropout", slot_order)
    swapped = run()
    monkeypatch.setattr(graph_layers, "compact_top_k_nodes", real_compact)
    assert float((swapped - run()).abs().max()) > 1e-3


def tiny_graph(n: int = 32, k: int = 4, graphs: int = 2, seed: int = 8) -> PaddedGraph:
    """Graphs of n nodes (the last 3 padding) with kNN edges of the real
    nodes, Morton-sorted, from numpy."""
    rs = np.random.RandomState(seed)
    fields = {f: [] for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask")}
    for _ in range(graphs):
        real = n - 3
        pos = np.zeros((n, 2), np.float32)
        pos[:real] = rs.rand(real, 2)
        d = ((pos[:real, None] - pos[None, :real]) ** 2).sum(-1) + np.eye(real) * 9.0
        nbr = np.zeros((n, k), np.int32)
        nbr[:real] = np.argsort(d, 1, kind="stable")[:, :k]
        mask = np.zeros((n, k), bool)
        mask[:real] = True
        node = np.arange(n) < real
        x = (rs.randn(n, 16) * node[:, None]).astype(np.float32)
        ea = (rs.rand(n, k, 3) * mask[..., None]).astype(np.float32)
        g = PaddedGraph(x=torch.from_numpy(x), pos=torch.from_numpy(pos),
                        nbr_idx=torch.from_numpy(nbr), nbr_mask=torch.from_numpy(mask),
                        edge_attr=torch.from_numpy(ea), node_mask=torch.from_numpy(node))
        g = halo.spatial_sort(g)
        for f in fields:
            fields[f].append(getattr(g, f))
    return PaddedGraph(**{f: torch.stack(v) for f, v in fields.items()}, y=None)


MODEL = dict(node_features=16, hidden_dims=(32, 16), num_diffusion_steps=3,
             attention_heads=4, graph_layers=2, num_classes=3, compute_dtype="float32",
             dropout=0.1)


def test_sp_forward_gradient_with_built_lists_equals_the_model(monkeypatch):
    """Over a model axis of 1 the block is the whole graph and the halo table
    holds N + 1 rows (H = 1): with the transposed lists built in the forward
    (as on the card: the table's M + 1 offsets, the outgoing rows' N + 1, the
    pooled levels' N'), the pretrain loss with dropout and the parameters'
    gradients within 1e-5 of the model's own forward."""
    monkeypatch.setattr(nt, "BUILD_DEVICES", ("cpu", "cuda"))
    built = []
    real = nt.neighbor_transpose

    def counting(idx, m=None):
        built.append((tuple(idx.shape), m))
        return real(idx, m)

    monkeypatch.setattr(nt, "neighbor_transpose", counting)
    g = tiny_graph()
    model = init_parameters(DGDMModel(**MODEL), torch.Generator().manual_seed(3))
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=1)
    mesh = Mesh(("data", "model"), (1, 1))

    def loss_and_grads(fn):
        model.zero_grad(set_to_none=True)
        out = fn(torch.Generator().manual_seed(4))
        loss = out["diffusion_loss"] + out["classification_logits"].square().mean()
        loss.backward()
        return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                             if p.grad is not None}

    got, got_g = loss_and_grads(lambda gen: sp_forward(
        model, g, plan, mesh, mode="pretrain", deterministic=False, generator=gen))
    assert ((2, 32, 4), 33) in built and ((2, 1, 1), 32) in built
    assert ((2, 16, 4), 16) in built and ((2, 8, 4), 8) in built
    want, want_g = loss_and_grads(lambda gen: model(g, mode="pretrain", deterministic=False,
                                                    generator=gen))
    assert got == pytest.approx(want, rel=1e-6)
    assert set(got_g) == set(want_g)
    for k, v in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_training_step_takes_a_plan_only_with_a_prepared_block():
    """A plan without ``prepared=True`` raises; ``prepared=True`` alone takes
    the batch as this process's rows, as JAX's does: one process's step is
    the same."""
    g = tiny_graph()

    def trainer():
        model = init_parameters(DGDMModel(**MODEL), torch.Generator().manual_seed(3))
        t = DGDMTrainer(model, TrainerConfig(), device="cpu")
        t.init_state(0)
        return t

    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=1)
    with pytest.raises(ValueError, match="prepared=True"):
        trainer().training_step(g, 0, plan=plan)
    assert trainer().training_step(g, 0, prepared=True) == trainer().training_step(g, 0)
