"""The transposed neighbor list (``ops/kernels/neighbor_transpose.py``): its
plain version against a numpy reference, the kernel's launch plan, a numpy
model of the kernel's phases under that plan, and where the model builds
the list.

The list is fixed by idx alone (every group in increasing slot order), so
the plain version is held to the reference exactly: counts, order inside each
group, out-of-range indices dropped, the -1 tail. The CUDA kernel is held
bit-equal to this plain version on the card in tests/test_torch_cuda.py; here
its launch plan is held to its invariants and the plan's segments and chunks,
walked as the kernel walks them, give the plain list.
"""

import numpy as np
import pytest
import torch

from dgdm_histopath_torch.ops import kernels
from dgdm_histopath_torch.ops.graph import compact_top_k_nodes
from dgdm_histopath_torch.ops.kernels import neighbor_transpose as nt


def reference(idx: np.ndarray, m=None):
    """(offsets [B, M+1], slots [B, N*K]) by a loop over destinations; M
    defaults to N."""
    b, n, k = idx.shape
    m = n if m is None else m
    offsets = np.zeros((b, m + 1), np.int64)
    slots = np.full((b, n * k), -1, np.int64)
    for bi in range(b):
        flat = idx[bi].reshape(-1)
        pos = 0
        for row in range(m):
            group = np.nonzero(flat == row)[0]         # increasing slot order
            slots[bi, pos:pos + len(group)] = group
            pos += len(group)
            offsets[bi, row + 1] = pos
    return offsets, slots


def _assert_matches_reference(idx: np.ndarray, m=None):
    out = nt.neighbor_transpose(torch.from_numpy(idx), m)
    ref_off, ref_slots = reference(idx, m)
    assert out.offsets.dtype == torch.int32 and out.slots.dtype == torch.int32
    np.testing.assert_array_equal(out.offsets.numpy(), ref_off)
    np.testing.assert_array_equal(out.slots.numpy(), ref_slots)
    return out


@pytest.mark.parametrize("shape,lo,hi", [((2, 16, 4), 0, 16), ((3, 100, 5), -3, 104),
                                         ((1, 37, 40), -1, 37), ((2, 7, 1), 0, 7)])
def test_plain_transpose_matches_the_numpy_reference(shape, lo, hi):
    idx = np.random.RandomState(0).randint(lo, hi, size=shape).astype(np.int32)
    out = _assert_matches_reference(idx)
    b, n, k = shape
    valid = (idx >= 0) & (idx < n)
    # counts are the in-degrees; every in-range slot appears exactly once
    np.testing.assert_array_equal(np.diff(out.offsets.numpy(), axis=1),
                                  [np.bincount(idx[i][valid[i]], minlength=n) for i in range(b)])
    for i in range(b):
        kept = out.slots[i, :int(out.offsets[i, n])].numpy()
        np.testing.assert_array_equal(np.sort(kept), np.nonzero(valid[i].reshape(-1))[0])


def test_out_of_range_indices_are_dropped():
    idx = np.array([[[0, -1], [5, 1], [1, 2]]], np.int32)          # N = 3, K = 2
    out = _assert_matches_reference(idx)
    assert out.offsets.tolist() == [[0, 1, 3, 4]]
    assert out.slots.tolist() == [[0, 3, 4, 5, -1, -1]]


def test_a_hub_row_keeps_its_slots_in_order():
    """Half of all slots point at node 0, as pooling leaves its dropped
    neighbors (~N*K/2 slots in one group)."""
    rs = np.random.RandomState(1)
    b, n, k = 2, 128, 8
    idx = rs.randint(0, n, size=(b, n, k)).astype(np.int32)
    idx[rs.rand(b, n, k) < 0.5] = 0
    out = _assert_matches_reference(idx)
    hub = out.slots[:, :int(out.offsets[0, 1])]
    assert hub.shape[1] > n * k // 2 - 64
    assert (hub[:, 1:] > hub[:, :-1]).all()


def test_a_pooled_level_from_compact_top_k_nodes():
    """The idx that compact pooling hands the next level: dropped neighbors
    sent to node 0 with their mask off, so node 0 is a hub."""
    rs = np.random.RandomState(2)
    b, n, k, keep = 2, 64, 6, 32
    x = torch.from_numpy(rs.randn(b, n, 4).astype(np.float32))
    idx = torch.from_numpy(rs.randint(0, n, size=(b, n, k)).astype(np.int32))
    mask = torch.ones(b, n, k, dtype=torch.bool)
    node_mask = torch.ones(b, n, dtype=torch.bool)
    node_mask[:, -8:] = False
    c = compact_top_k_nodes(x, idx, mask, node_mask, torch.from_numpy(rs.randn(b, n)), keep)
    pooled = c["nbr_idx"].numpy()
    out = _assert_matches_reference(pooled)
    assert int(out.offsets[0, 1]) >= (~c["nbr_mask"][0]).sum().item()


def test_empty_and_degenerate_shapes():
    for shape in ((0, 4, 2), (2, 3, 0), (1, 1, 1)):
        idx = np.zeros(shape, np.int32)
        _assert_matches_reference(idx)


def test_check_transpose_refuses_a_list_of_another_shape():
    idx = torch.zeros(2, 5, 3, dtype=torch.int32)
    t = nt.neighbor_transpose(idx)
    nt.check_transpose(t, idx)
    with pytest.raises(ValueError, match="does not fit"):
        nt.check_transpose(t, torch.zeros(2, 6, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        nt.check_transpose(nt.NeighborTranspose(t.offsets.long(), t.slots), idx)
    with pytest.raises(ValueError, match="int32"):
        nt.neighbor_transpose(idx.long())


def test_the_cpu_build_launches_nothing():
    before = kernels.launch_counts()
    nt.neighbor_transpose(torch.zeros(2, 5, 3, dtype=torch.int32))
    assert kernels.launch_counts() == before


def test_transpose_for_backward_builds_only_where_a_gradient_is_taken(monkeypatch):
    idx = torch.randint(0, 9, (2, 9, 3), dtype=torch.int32)
    assert nt.transpose_for_backward(idx) is None                  # a CPU tensor
    monkeypatch.setattr(nt, "BUILD_DEVICES", ("cuda", "cpu"))
    built = nt.transpose_for_backward(idx)
    assert built is not None and torch.equal(built.slots, nt.neighbor_transpose(idx).slots)
    with torch.no_grad():
        assert nt.transpose_for_backward(idx) is None
    with torch.inference_mode():
        assert nt.transpose_for_backward(idx) is None


def test_real_edge_index_changes_no_forward_value_and_no_gradient():
    """Masked-off slots pointed outside [0, N) instead of at node 0: a
    DynamicGraphLayer gives the same output and the same input gradient, and
    the transposed list no longer holds a hub at node 0."""
    from dgdm_histopath_torch.nn.graph_layers import DynamicGraphLayer
    from dgdm_histopath_torch.nn.layers import init_parameters
    from dgdm_histopath_torch.ops.graph import real_edge_index

    rs = np.random.RandomState(3)
    b, n, k, f = 2, 48, 6, 16
    idx = torch.from_numpy(rs.randint(0, n, size=(b, n, k)).astype(np.int32))
    mask = torch.from_numpy(rs.rand(b, n, k) < 0.6)
    idx = torch.where(mask, idx, 0)                        # the padded format's node 0
    edge = torch.from_numpy(rs.rand(b, n, k, 3).astype(np.float32)) * mask[..., None]
    layer = init_parameters(DynamicGraphLayer(f, f, 4, edge_dim=3),
                            torch.Generator().manual_seed(0))
    remapped = real_edge_index(idx, mask)
    assert remapped.dtype == idx.dtype and torch.equal(remapped[mask], idx[mask])
    assert (remapped[~mask] == -1).all()
    x0 = torch.from_numpy(rs.randn(b, n, f).astype(np.float32))
    outs = []
    for i in (idx, remapped):
        x = x0.clone().requires_grad_()
        y = layer(x, i, mask, edge)
        (dx,) = torch.autograd.grad(y.square().sum(), x)
        outs.append((y.detach(), dx))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-6, rtol=1e-6)
    hub = nt.neighbor_transpose(idx).offsets[:, 1]
    assert (hub >= (~mask).flatten(1).sum(1)).all()
    assert (nt.neighbor_transpose(remapped).offsets[:, -1] == mask.flatten(1).sum(1)).all()


# (B, N, K, M, index kind): the lists a cluster of CTAs has to get right
EDGE_LISTS = {
    "every slot at one row": (1, 1024, 8, None, "one row"),
    "every index out of range": (2, 64, 8, None, "out of range"),
    "M = 1": (2, 50, 6, 1, "ragged"),
    "M > N": (2, 40, 8, 300, "ragged"),
    "M < N": (2, 100, 8, 30, "ragged"),
    "N * K not a multiple of 32": (3, 37, 5, None, "ragged"),
    "B 1 at N 8192": (1, 8192, 8, None, "random"),
}


def edge_indices(b, n, k, m, kind, seed=11):
    """idx of a named kind over m rows: ``random`` in [0, m), ``ragged`` in
    [-2, m + 2), ``one row`` every slot at row 7, ``out of range`` none in
    [0, m)."""
    rs = np.random.RandomState(seed)
    if kind == "one row":
        return np.full((b, n, k), 7, np.int32)
    if kind == "out of range":
        return np.where(rs.rand(b, n, k) < 0.5, rs.randint(m, m + 8, (b, n, k)),
                        rs.randint(-8, 0, (b, n, k))).astype(np.int32)
    lo, hi = (0, m) if kind == "random" else (-2, m + 2)
    return rs.randint(lo, hi, size=(b, n, k)).astype(np.int32)


@pytest.mark.parametrize("case", list(EDGE_LISTS))
def test_plain_transpose_matches_the_reference_on_edge_lists(case):
    b, n, k, m, kind = EDGE_LISTS[case]
    m = n if m is None else m
    out = _assert_matches_reference(edge_indices(b, n, k, m, kind), m)
    assert out.offsets.shape == (b, m + 1) and out.slots.shape == (b, n * k)
    kept = out.offsets[:, -1]
    if kind == "one row":
        assert (kept == n * k).all() and (out.offsets[:, 8] == n * k).all()
    if kind == "out of range":
        assert (kept == 0).all() and (out.slots == -1).all()


# (B, N, K, M): the model's levels, the node-sharded tier's bucket 8192 and
# its rectangular tables, batch 1, a batch that fills the card alone, N * K
# off the tiles, tiny and empty lists, a table too large for shared memory
PLAN_SHAPES = [(32, 1024, 8, 1024), (32, 256, 8, 256), (4, 2048, 8, 2048), (4, 512, 8, 512),
               (1, 8192, 8, 8192), (1, 1024, 8, 1024), (8, 1024, 8, 1024),
               (32, 512, 8, 622), (32, 2, 55, 512), (4, 1000, 7, 1000), (32, 100, 5, 100),
               (200, 1024, 8, 1024), (3, 37, 5, 1), (2, 5, 0, 5), (1, 1, 1, 0),
               (1, 2048, 8, 16384)]


def _segments(plan, nk):
    """The slot segments of the plan's CTAs, as the kernel cuts them."""
    return [(min(nk, r * plan.segment), min(nk, min(nk, r * plan.segment) + plan.segment))
            for r in range(plan.cluster)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_keeps_its_invariants(shape):
    b, n, k, m = shape
    plan = nt.launch_plan(b, n, k, m)
    c, w = plan.cluster, plan.warps
    # up to 16 CTAs: above 8 the launch sets cudaFuncAttributeNonPortableClusterSizeAllowed
    assert 1 <= c <= nt.MAX_CLUSTER == 16 and c & (c - 1) == 0
    assert plan.grid == b * c and plan.threads == 32 * w and w in nt.WARP_CHOICES
    assert c == 1 or b * c <= nt.SMS
    # the CTAs' segments: whole tiles for every warp, disjoint, in slot order, covering N * K
    assert plan.segment % (32 * w) == 0
    cut = _segments(plan, n * k)
    assert [s for lo, hi in cut for s in range(lo, hi)] == list(range(n * k))
    assert plan.chunk * c >= m and plan.chunk % 4 == 0 and plan.chunk - 4 < -(-m // c)
    # shared memory within the card's 227 KiB, with the most warps that fit;
    # no global scratch at any bucket the presets or the node-sharded tier use
    assert plan.smem <= nt.SMEM_LIMIT and plan.smem + 1152 <= 227 * 1024   # + static smem
    fits = [x for x in nt.WARP_CHOICES if 4 * nt.cta_ints(m, x, c, plan.chunk) <= nt.SMEM_LIMIT]
    if m <= 8192:
        assert fits and plan.scratch == 0
    if fits:
        assert w == fits[0] and plan.smem == 4 * nt.cta_ints(m, w, c, plan.chunk)
        assert plan.scratch == 0
    else:
        assert w == 4 and plan.smem == 0
        assert plan.scratch == b * c * nt.cta_ints(m, 4, c, plan.chunk)


@pytest.mark.parametrize("shape,cluster", [((32, 1024, 8), 4), ((4, 2048, 8), 16),
                                           ((1, 8192, 8), 16), ((200, 1024, 8), 1),
                                           ((32, 2, 55), 4), ((66, 100, 5), 2)])
def test_launch_plan_spreads_a_graph_to_fill_the_card(shape, cluster):
    """B * C fills the 132 SMs: 4 CTAs a graph for the Base step, 16 for the
    Large step and batch 1, one once the batch alone fills the card; small
    graphs (the halo's outgoing rows, 110 slots) are spread all the same."""
    b, n, k = shape
    assert nt.launch_plan(b, n, k, n).cluster == cluster


def kernel_model(idx: np.ndarray, m: int, plan):
    """The kernel's four phases in numpy, with the plan's cluster, warps,
    segments and chunks: each warp's counts and each slot's rank within its
    warp's part (32-slot tiles in slot order), each CTA's share of a row and
    where each warp's slots start in it, the scan across the cluster by
    chunks of rows, and each slot placed at its CTA's start of its row plus
    its warp's start plus its rank."""
    b, n, k = idx.shape
    nk, c, w_ = n * k, plan.cluster, plan.warps
    part = plan.segment // w_
    offsets = np.zeros((b, m + 1), np.int64)
    slots = np.full((b, nk), 12345, np.int64)            # the kernel writes every slot
    parts = {(r, w): (min(hi, lo + w * part), min(hi, lo + (w + 1) * part))
             for r, (lo, hi) in enumerate(_segments(plan, nk)) for w in range(w_)}
    for g in range(b):
        flat = idx[g].reshape(-1)
        cnt = np.zeros((c, w_, m), np.int64)
        rank = np.zeros(nk, np.int64)
        for (r, w), (lo, hi) in parts.items():
            for t0 in range(lo, hi, 32):
                keys = flat[t0:min(hi, t0 + 32)]
                for lane, key in enumerate(keys):
                    if 0 <= key < m:
                        rank[t0 + lane] = cnt[r, w, key] + int(np.sum(keys[:lane] == key))
                for key in np.unique(keys[(keys >= 0) & (keys < m)]):
                    cnt[r, w, key] += int(np.sum(keys == key))
        tot = cnt.sum(1)
        cnt = np.cumsum(cnt, 1) - cnt                    # where each warp starts
        chunks = [(min(m, r * plan.chunk), min(m, min(m, r * plan.chunk) + plan.chunk))
                  for r in range(c)]
        csum = [tot[:, lo:hi].sum() for lo, hi in chunks]
        starts = np.zeros((c, m), np.int64)
        for r, (lo, hi) in enumerate(chunks):
            start = sum(csum[:r])
            for row in range(lo, hi):
                offsets[g, row] = start
                for r2 in range(c):
                    starts[r2, row] = start
                    start += tot[r2, row]
        offsets[g, m] = sum(csum)
        slots[g, sum(csum):] = -1
        for (r, w), (lo, hi) in parts.items():
            for s in range(lo, hi):
                if 0 <= flat[s] < m:
                    slots[g, starts[r, flat[s]] + cnt[r, w, flat[s]] + rank[s]] = s
    return offsets, slots


@pytest.mark.parametrize("shape,kind", [((4, 300, 8, 300), "ragged"), ((2, 256, 8, 256), "hub"),
                                        ((1, 200, 8, 640), "ragged"), ((3, 370, 5, 1), "ragged"),
                                        ((1, 64, 8, 64), "one row")])
def test_the_kernels_phases_under_its_plan_give_the_plain_list(shape, kind):
    b, n, k, m = shape
    idx = edge_indices(b, n, k, m, "random" if kind == "hub" else kind)
    if kind == "hub":
        idx[np.random.RandomState(4).rand(b, n, k) < 0.5] = 0
    plan = nt.launch_plan(b, n, k, m)
    assert plan.cluster > 1
    off, slots = kernel_model(idx, m, plan)
    want = nt.neighbor_transpose_plain(torch.from_numpy(idx), m)
    np.testing.assert_array_equal(off, want.offsets.numpy())
    np.testing.assert_array_equal(slots, want.slots.numpy())


@pytest.mark.parametrize("shape,m", [((1, 2 ** 28, 8), None), ((2, 16, 4), 2 ** 31)])
def test_check_refuses_lists_that_overflow_int32(shape, m):
    """N * K slots or M rows past int32: refused before anything is built."""
    idx = torch.empty(shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="do not fit int32"):
        nt.neighbor_transpose(idx, m)
