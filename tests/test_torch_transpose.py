"""The transposed neighbor list (``ops/kernels/neighbor_transpose.py``): its
plain version against a numpy reference, and where the model builds it.

The list is fixed by idx alone (every group in increasing slot order), so
the plain version is held to the reference exactly: counts, order inside each
group, out-of-range indices dropped, the -1 tail. The CUDA kernel is held
bit-equal to this plain version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from dgdm_histopath_torch.ops import kernels
from dgdm_histopath_torch.ops.graph import compact_top_k_nodes
from dgdm_histopath_torch.ops.kernels import neighbor_transpose as nt


def reference(idx: np.ndarray):
    """(offsets [B, N+1], slots [B, N*K]) by a loop over destinations."""
    b, n, k = idx.shape
    offsets = np.zeros((b, n + 1), np.int64)
    slots = np.full((b, n * k), -1, np.int64)
    for bi in range(b):
        flat = idx[bi].reshape(-1)
        pos = 0
        for m in range(n):
            group = np.nonzero(flat == m)[0]           # increasing slot order
            slots[bi, pos:pos + len(group)] = group
            pos += len(group)
            offsets[bi, m + 1] = pos
    return offsets, slots


def _assert_matches_reference(idx: np.ndarray):
    out = nt.neighbor_transpose(torch.from_numpy(idx))
    ref_off, ref_slots = reference(idx)
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
