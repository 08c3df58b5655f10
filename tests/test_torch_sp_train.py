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
  the CPU: the parameters' gradients within 1e-5 of the model's, also with
  DGDM-Large's two windows.
* The band over a node block: its level gives its layers the whole graph's
  band-pruned rows and their degree normalization.
* ``training_step`` refuses a plan without a prepared block.
* The MoE over a node block (``MoEFFN.route`` / ``forward`` with a
  ``KeyBlock``): groups inside a block, straddling the ranks of one graph
  and straddling graphs and ranks, top-1 and top-2 with capacity drops (the
  second slot offset by the whole group's kept first choices): every rank's
  routing equal to the whole groups', its output rows within 1e-6 of theirs
  and the aux loss equal.
* A remat step over a model line of threads (``ThreadAxis``: the line's
  collectives through shared memory, each a barrier with a timeout, so a
  rank that waits on a collective the others do not issue fails the test in
  seconds instead of hanging it): every rank issues the same collectives in
  the same order, each encoder layer's three halo exchanges once more than
  without remat, and the gradients summed over the ranks are one process's.

The inputs are made with numpy from a seed.
"""

import threading

import numpy as np
import pytest
import torch

from dgdm_histopath_torch.models.dgdm import DGDMModel
from dgdm_histopath_torch.nn.attention import KeyBlock
from dgdm_histopath_torch.nn.layers import NodeRows, dropout, init_parameters
from dgdm_histopath_torch.nn.moe import MoEFFN
from dgdm_histopath_torch.ops.graph import (
    PaddedGraph,
    band_eligible,
    band_prune,
    in_band_mask,
    real_edge_index,
    symmetric_norm,
)
from dgdm_histopath_torch.ops.kernels import neighbor_transpose as nt
from dgdm_histopath_torch.ops.kernels.gather_agg import (
    weighted_gather_sum,
    weighted_gather_sum_bwd_plain,
)
from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_bwd_plain
from dgdm_histopath_torch.parallel import halo, shard_graph_nodes, sp, sp_forward
from dgdm_histopath_torch.parallel.mesh import Axis, Mesh
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


def loss_and_grads(model, fn):
    """``fn(generator)``'s pretrain loss plus a logits term, and the
    parameters' gradients of it."""
    model.zero_grad(set_to_none=True)
    out = fn(torch.Generator().manual_seed(4))
    loss = out["diffusion_loss"] + out["classification_logits"].square().mean()
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                                  if p.grad is not None}


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

    got, got_g = loss_and_grads(model, lambda gen: sp_forward(
        model, g, plan, mesh, mode="pretrain", deterministic=False, generator=gen))
    assert ((2, 32, 4), 33) in built and ((2, 1, 1), 32) in built
    assert ((2, 16, 4), 16) in built and ((2, 8, 4), 8) in built
    want, want_g = loss_and_grads(model, lambda gen: model(g, mode="pretrain",
                                                           deterministic=False, generator=gen))
    assert got == pytest.approx(want, rel=1e-6)
    assert set(got_g) == set(want_g)
    for k, v in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("n,tp", [(32, 2), (32, 4), (16, 2)])
def test_in_band_mask_over_a_block_equals_the_whole_graphs_rows(n, tp):
    """A node block's level (``sp._level`` with band 8) gives its layers
    the whole graph's band-pruned rows [lo, lo + n/tp) and their degree
    normalization, as one process prunes them: with 4 windows a block of one
    window still takes the band (a rule decided on its 8 rows would not);
    with 2 windows no block does."""
    g = tiny_graph(n=n)
    idx = real_edge_index(g.nbr_idx, g.nbr_mask)
    masked = g.nbr_mask & g.node_mask[..., None]
    whole = band_prune(idx, masked, 8)
    assert torch.equal(whole, in_band_mask(idx, masked, 8) if band_eligible(n, 8) else masked)
    assert band_eligible(n, 8) == (n // 8 >= 3) and bool((whole != masked).any()) == (
        n // 8 >= 3)
    norm = symmetric_norm(idx, whole)
    n_loc = n // tp
    for r in range(tp):
        lvl = sp._level(idx, g.nbr_mask, g.node_mask, None, Axis("model", tp, r),
                        table=lambda t: t, band=8)
        rows = slice(r * n_loc, (r + 1) * n_loc)
        assert lvl.nbrs.band == 8 and torch.equal(lvl.nbrs.mask, whole[:, rows])
        for got, want in zip(lvl.nbrs.norm, norm):
            assert torch.equal(got, want[:, rows])


def test_sp_forward_gradient_with_both_windows_equals_the_model():
    """The gradient test above on the model with both windows (W 8 on the
    32 bucket's 4 windows: banded layers over the block's halo table, the
    window route through the ring, which one rank wraps onto itself), and
    with the lists built on the CPU: the pretrain loss with dropout on the
    window weights and the parameters' gradients within 1e-5 of the
    model's."""
    g = tiny_graph()
    model = init_parameters(DGDMModel(**MODEL, spatial_window=8, graph_window=8),
                            torch.Generator().manual_seed(3))
    assert model.spatial_attention.route(32, deterministic=False) == "window"
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp=1)
    mesh = Mesh(("data", "model"), (1, 1))
    got, got_g = loss_and_grads(model, lambda gen: sp_forward(
        model, g, plan, mesh, mode="pretrain", deterministic=False, generator=gen))
    want, want_g = loss_and_grads(model, lambda gen: model(
        g, mode="pretrain", deterministic=False, generator=gen))
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


# (graphs, nodes, tp, group): a group of 8 inside a block of 16 rows, of 32
# over two blocks of one graph, of 64 over two graphs of 32 and their blocks
PLACEMENTS = {"inside_a_block": (2, 32, 2, 8), "straddles_ranks": (2, 32, 2, 32),
              "straddles_graphs_and_ranks": (4, 32, 4, 64)}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_moe_routing_over_a_node_block_equals_the_whole_groups(placement, top_k):
    """Each rank's ``route`` with its block (its rows' probabilities, the
    others' gathered) gives the whole groups' dispatch, kept tokens and first
    choices bit for bit and their probabilities and combine weights; its
    ``forward`` output is its rows of the whole output within 1e-6 and the
    aux loss the whole groups'. Capacity 0.5 drops tokens; at top-2 the
    second slot's positions start after the whole group's kept first
    choices, which a block's own count would not give."""
    b, n, tp, grp = PLACEMENTS[placement]
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.randn(b, n, 16).astype(np.float32))
    mask = torch.from_numpy(rs.rand(b, n) < 0.9)
    moe = init_parameters(MoEFFN(16, 32, num_experts=4, top_k=top_k, capacity_factor=0.5,
                                 group_size=grp, dtype=torch.float32),
                          torch.Generator().manual_seed(13))
    whole = moe.route(x, mask)
    out, aux = moe(x, mask)
    assert whole["dispatch"].shape[:2] == (b * n // grp, grp)
    real = mask.reshape(whole["kept"].shape[:2])
    assert ((whole["kept"].sum(-1) == 0) & real).any()            # drops
    n_loc = n // tp
    blocks = [x[:, r * n_loc:(r + 1) * n_loc] for r in range(tp)]

    def gather(r):
        def fn(t):          # the line's probabilities, this rank's own part t
            parts = [torch.softmax(moe.router(p), -1) for p in blocks]
            parts[r] = t
            return torch.cat(parts, 1)
        return fn

    for r in range(tp):
        block = KeyBlock(NodeRows(n, lo=r * n_loc), gather(r), None)
        got = moe.route(blocks[r], mask, block=block)
        for key in ("dispatch", "kept", "first_choice", "mask"):
            assert torch.equal(got[key], whole[key]), key
        for key in ("probs", "combine"):
            torch.testing.assert_close(got[key], whole[key], atol=1e-7, rtol=0)
        got_out, got_aux = moe(blocks[r], mask, block=block)
        torch.testing.assert_close(got_out, out[:, r * n_loc:(r + 1) * n_loc], atol=1e-6,
                                   rtol=0)
        assert float(got_aux.detach()) == float(aux.detach())
    # a straddling group's positions depend on the other blocks' tokens: a
    # route that sees only the last block's (the others masked off) places
    # them elsewhere; a group inside a block is the block's own
    only = mask.clone()
    only[:, :n - n_loc] = False
    lone = moe.route(x, only)["dispatch"].reshape(b, n, 4, -1)[:, n - n_loc:]
    mine = whole["dispatch"].reshape(b, n, 4, -1)[:, n - n_loc:]
    assert torch.equal(lone, mine) == (placement == "inside_a_block")


class ThreadAxis(Axis):
    """A model line whose ranks are threads of this process: each collective
    posts this rank's tensor and its signature, meets the others at a barrier
    (``timeout`` seconds: a rank left waiting raises), and fails where the
    ranks issued different collectives. ``log`` keeps each rank's
    signatures in order."""

    def __init__(self, board: dict, index: int):
        super().__init__("model", board["size"], index)
        self.board = board

    def _exchange(self, op: str, t: torch.Tensor) -> list:
        b = self.board
        sig = (op, tuple(t.shape), t.dtype)
        b["log"][self.index].append(sig)
        b["slots"][self.index] = (sig, t.detach().clone())
        b["barrier"].wait()
        posted = list(b["slots"])
        b["barrier"].wait()
        if any(p[0] != sig for p in posted):
            raise AssertionError(f"rank {self.index} issued {sig}, the line "
                                 f"{[p[0] for p in posted]}")
        return [p[1] for p in posted]

    def all_reduce_(self, t):
        parts = self._exchange("all_reduce", t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return t.copy_(total)

    def broadcast_(self, t, index=0):
        return t.copy_(self._exchange("broadcast", t)[index])

    def all_gather(self, t, dim=0):
        return torch.cat(self._exchange("all_gather", t), dim)

    def all_to_all(self, t, dim=0):
        parts = self._exchange("all_to_all", t)
        return torch.cat([p.chunk(self.size, dim)[self.index] for p in parts], dim)

    def shift(self, t, offset=1):
        return self._exchange("shift", t)[(self.index - offset) % self.size].clone()


def run_line(tp: int, fn, timeout: float = 60.0):
    """``fn(mesh, rank)`` on a (1, tp) mesh of threads; returns each rank's
    result and its collectives in order. A rank's error (a broken barrier
    included) aborts the others and is raised."""
    board = {"size": tp, "barrier": threading.Barrier(tp, timeout=timeout),
             "slots": [None] * tp, "log": [[] for _ in range(tp)]}
    results, errors = [None] * tp, []

    def work(r):
        try:
            mesh = Mesh(("data", "model"), (1, tp), lines={"model": ThreadAxis(board, r)})
            results[r] = fn(mesh, r)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            board["barrier"].abort()

    threads = [threading.Thread(target=work, args=(r,), daemon=True) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(4 * timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return results, board["log"]


def remat_step(state, g, tp: int, remat: bool):
    """A pretrain step's loss and gradients over a (1, tp) line of threads:
    ``sp_pretrain_step`` at dropout 0.1 with the MoE, each rank's loss its
    share (the per-node terms over the line's counts, the graph-level terms
    divided by the line), backward on every rank."""
    plan = halo.build_halo_plan(g.nbr_idx, g.nbr_mask, tp)

    def fn(mesh, r):
        model = DGDMModel(**MODEL, use_remat=remat, moe_experts=4, moe_top_k=2)
        model.load_state_dict(state)
        out = sp.sp_pretrain_step(model, shard_graph_nodes(g, mesh), plan, mesh,
                                  generator=torch.Generator().manual_seed(4))
        loss = (out["diffusion_loss"] + out["reconstruction_loss"]
                + (out["classification_logits"].square().mean() + out["moe_aux_loss"]) / tp)
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None}

    return run_line(tp, fn)


@pytest.mark.parametrize("tp", [2, 4])
def test_a_remat_step_issues_the_same_collectives_on_every_rank(tp):
    """A node-sharded pretrain step with ``use_remat`` (2 encoder layers,
    the MoE, dropout 0.1) over a line of tp threads: every rank issues the
    same collectives, in the same order, with the same shapes; the recompute
    adds each layer's three halo exchanges (all_to_all) and nothing else;
    the summed loss and the gradients summed over the ranks are one
    process's with remat (1e-5)."""
    g = tiny_graph(n=32, graphs=2)
    model = init_parameters(DGDMModel(**MODEL, use_remat=True, moe_experts=4, moe_top_k=2),
                            torch.Generator().manual_seed(3))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = model.pretrain_step(g, generator=torch.Generator().manual_seed(4))
    loss = (out["diffusion_loss"] + out["reconstruction_loss"]
            + out["classification_logits"].square().mean() + out["moe_aux_loss"])
    loss.backward()
    want = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    loss = float(loss.detach())
    ranks, log = remat_step(state, g, tp, remat=True)
    _, plain = remat_step(state, g, tp, remat=False)
    assert all(entry == log[0] for entry in log)
    exchanges = [[s for s in seq if s[0] == "all_to_all"] for seq in (log[0], plain[0])]
    assert len(exchanges[0]) == len(exchanges[1]) + 3 * MODEL["graph_layers"]
    assert [s for s in log[0] if s[0] != "all_to_all"] == \
        [s for s in plain[0] if s[0] != "all_to_all"]
    assert sum(r[0] for r in ranks) == pytest.approx(loss, rel=1e-6)
    assert set(ranks[0][1]) == set(want)
    for k, v in want.items():
        got = sum(r[1][k] for r in ranks)
        np.testing.assert_allclose(got.numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_moe_groups_are_the_global_batchs_and_never_straddle_data_ranks():
    """Over node blocks the MoE routes in the global batch's groups
    (``sp.moe_group``): 4 graphs of 32 nodes a data rank of two make one
    group of 256 tokens, which would straddle the two data ranks and
    raises; 4 graphs of 256 make groups of 1024, one a data rank; one data
    rank takes min(1024, its tokens)."""
    model = DGDMModel(**MODEL, moe_experts=4)
    two = Mesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="straddle two data ranks"):
        sp.moe_group(model, 4, 32, two)
    assert sp.moe_group(model, 4, 256, two) == 1024
    assert sp.moe_group(model, 4, 32, Mesh(("data", "model"), (1, 2))) == 128
