"""Parity of the port's ``ops/graph.py`` with the JAX package's, on the CPU.

The same seeded numpy inputs go through both; integer and selection
results must be equal, float results agree to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.ops import graph as jg
from dgdm_histopath_torch.ops import graph as tg


def _graph_arrays(b=2, n=32, k=6, f=8, e=3, n_real=25, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, f).astype(np.float32)
    idx = rs.randint(0, n, (b, n, k)).astype(np.int32)
    node_mask = np.zeros((b, n), bool)
    node_mask[:, :n_real] = True
    nbr_mask = (rs.rand(b, n, k) > 0.2) & node_mask[..., None]
    edge_attr = rs.randn(b, n, k, e).astype(np.float32)
    score = rs.randn(b, n).astype(np.float32)
    return x, idx, nbr_mask, node_mask, edge_attr, score


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_gather_neighbors_matches_take_along_axis():
    x, idx, *_ = _graph_arrays()
    ref = jg.gather_neighbors(jnp.asarray(x), jnp.asarray(idx), impl="take")
    out = tg.gather_neighbors(_t(x), _t(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_scalar_degrees_symmetric_norm():
    _, idx, nbr_mask, *_ = _graph_arrays()
    vals = np.random.RandomState(1).rand(2, 32).astype(np.float32)
    np.testing.assert_array_equal(
        tg.gather_scalar(_t(vals), _t(idx)).numpy(),
        np.asarray(jg.gather_scalar(jnp.asarray(vals), jnp.asarray(idx))))
    np.testing.assert_array_equal(tg.degrees(_t(nbr_mask)).numpy(),
                                  np.asarray(jg.degrees(jnp.asarray(nbr_mask))))
    en, sn = tg.symmetric_norm(_t(idx), _t(nbr_mask))
    jen, jsn = jg.symmetric_norm(jnp.asarray(idx), jnp.asarray(nbr_mask))
    np.testing.assert_allclose(en.numpy(), np.asarray(jen), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sn.numpy(), np.asarray(jsn), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [-1, -2])
def test_masked_softmax_matches_and_zeroes_fully_masked(dim):
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 7, 5).astype(np.float32) * 4
    mask = rs.rand(3, 7, 5) > 0.4
    mask[0] = False                         # fully-masked rows along both axes
    out = tg.masked_softmax(_t(logits), _t(mask), dim=dim).numpy()
    ref = np.asarray(jg.masked_softmax(jnp.asarray(logits), jnp.asarray(mask), axis=dim))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out[0], 0.0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("with_ties", [False, True])
def test_compact_top_k_nodes_matches(with_ties):
    x, idx, nbr_mask, node_mask, edge_attr, score = _graph_arrays()
    if with_ties:                          # stable order: lower index first
        score = np.round(score, 0).astype(np.float32)
    keep = 16
    with jax.default_matmul_precision("float32"):
        ref = jg.compact_top_k_nodes(jnp.asarray(x), jnp.asarray(idx),
                                     jnp.asarray(nbr_mask), jnp.asarray(node_mask),
                                     jnp.asarray(score), keep, jnp.asarray(edge_attr))
    out = tg.compact_top_k_nodes(_t(x), _t(idx), _t(nbr_mask), _t(node_mask),
                                 _t(score), keep, _t(edge_attr))
    np.testing.assert_array_equal(out["sel_idx"].numpy(), np.asarray(ref["sel_idx"]))
    for key in ("nbr_idx", "nbr_mask", "node_mask"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert out["nbr_idx"].dtype == torch.int32
    for key in ("x", "edge_attr"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_out_of_range_neighbor_is_an_absent_edge():
    """An index outside [0, N) gives 0 in gather_scalar and the edge norm, and
    compact_top_k_nodes drops the edge: the same result as JAX on the graph
    with that slot masked out. torch.gather never sees the bad index (on the
    card it would be a device-side assert)."""
    x, idx, nbr_mask, node_mask, edge_attr, score = _graph_arrays(seed=7)
    rs = np.random.RandomState(8)
    bad = rs.rand(*idx.shape) < 0.15
    bad_idx = np.where(bad, rs.choice([-5, -1, 32, 40], idx.shape), idx).astype(np.int32)
    vals = rs.rand(2, 32).astype(np.float32)
    out = tg.gather_scalar(_t(vals), _t(bad_idx)).numpy()
    np.testing.assert_array_equal(out[bad], 0.0)
    np.testing.assert_array_equal(out[~bad], np.take_along_axis(
        vals, idx.reshape(2, -1), -1).reshape(idx.shape)[~bad])
    en, _ = tg.symmetric_norm(_t(bad_idx), _t(nbr_mask))
    np.testing.assert_array_equal(en.numpy()[bad], 0.0)

    keep = 16
    with jax.default_matmul_precision("float32"):
        ref = jg.compact_top_k_nodes(jnp.asarray(x), jnp.asarray(np.where(bad, 0, idx)),
                                     jnp.asarray(nbr_mask & ~bad), jnp.asarray(node_mask),
                                     jnp.asarray(score), keep, jnp.asarray(edge_attr))
    out = tg.compact_top_k_nodes(_t(x), _t(bad_idx), _t(nbr_mask), _t(node_mask),
                                 _t(score), keep, _t(edge_attr))
    for key in ("sel_idx", "nbr_idx", "nbr_mask", "node_mask", "x", "edge_attr"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_scatter_nodes_matches():
    rs = np.random.RandomState(3)
    h = rs.randn(2, 5, 4).astype(np.float32)
    sel = np.stack([rs.permutation(9)[:5] for _ in range(2)]).astype(np.int64)
    valid = rs.rand(2, 5) > 0.3
    ref = jg.scatter_nodes(jnp.asarray(h), jnp.asarray(sel), 9, valid=jnp.asarray(valid))
    out = tg.scatter_nodes(_t(h), _t(sel), 9, valid=_t(valid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_masked_global_pools_match():
    x, _, _, node_mask, *_ = _graph_arrays()
    np.testing.assert_allclose(
        tg.masked_global_mean(_t(x), _t(node_mask)).numpy(),
        np.asarray(jg.masked_global_mean(jnp.asarray(x), jnp.asarray(node_mask))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tg.masked_global_max(_t(x), _t(node_mask)).numpy(),
        np.asarray(jg.masked_global_max(jnp.asarray(x), jnp.asarray(node_mask))))


@pytest.mark.parametrize("n,expected", [(1, 128), (128, 128), (129, 256), (5000, 2048)])
def test_pick_bucket(n, expected):
    buckets = (128, 256, 512, 1024, 2048)
    assert tg.pick_bucket(n, buckets) == jg.pick_bucket(n, buckets) == expected


def test_build_padded_graph_and_batch_match():
    rs = np.random.RandomState(4)
    n, k = 20, 4
    args = (rs.randn(n, 6).astype(np.float32), rs.rand(n, 2).astype(np.float32),
            rs.randint(0, n, (n, k)), rs.rand(n, k, 3).astype(np.float32),
            rs.rand(n, k) > 0.3)
    gt = [tg.build_padded_graph(*args, bucket=32) for _ in range(2)]
    gj = [jg.build_padded_graph(*args, bucket=32) for _ in range(2)]
    bt, bj = tg.batch_graphs(gt), jg.batch_graphs(gj)
    for f in ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(), np.asarray(getattr(bj, f)),
                                      err_msg=f)
    assert bt.nbr_idx.dtype == torch.int32 and bt.num_nodes == 32
    assert bt.max_neighbors == k and bt.feature_dim == 6
    assert bt.node_mask.sum(-1).tolist() == [n, n]
    with pytest.raises(ValueError):
        tg.build_padded_graph(*args, bucket=16)
    with pytest.raises(ValueError):
        tg.batch_graphs([])


def test_padded_graph_to_and_unsqueeze():
    x, idx, nbr_mask, node_mask, edge_attr, _ = _graph_arrays(b=1)
    g = tg.PaddedGraph(x=_t(x[0]), pos=torch.zeros(32, 2), nbr_idx=_t(idx[0]),
                       nbr_mask=_t(nbr_mask[0]), edge_attr=_t(edge_attr[0]),
                       node_mask=_t(node_mask[0]))
    gb = g.unsqueeze().to("cpu")
    assert gb.x.shape == (1, 32, 8) and gb.y is None
    assert torch.equal(gb.nbr_idx[0], g.nbr_idx)
