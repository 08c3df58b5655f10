"""The port's kNN graph construction (``dgdm_histopath_torch/ops/knn.py``)
against the JAX package's ``ops/knn.py``, on the CPU.

Neighbour lists are compared slot for slot, not as sets: on a patch lattice
exact distance ties are the rule, and the reference's ``lax.top_k`` puts the
lower index first among them. The port reproduces the reference's f32
rounding of the distances (and of cosine similarities over up to 8 feature
dimensions), so those are compared bit for bit; similarities over more
dimensions are f64 products rounded to f32 in the port, held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.ops import knn as jknn
from dgdm_histopath_tpu.parallel.halo import morton_keys as jax_morton_keys
from dgdm_histopath_torch.ops import knn
from dgdm_histopath_torch.ops.graph import morton_keys


def lattice(nx=20, ny=15, patch=256, width=5000.0):
    """Patch centres of an nx x ny grid of 256-px patches, normalized as the
    graph builder normalizes them."""
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    grid = np.stack([gx, gy], -1).reshape(-1, 2) * patch + patch / 2
    return (grid / np.float32(width)).astype(np.float32)


def positions(kind):
    rs = np.random.RandomState(0)
    pos = lattice() if kind == "lattice" else rs.rand(300, 2).astype(np.float32)
    mask = np.ones(len(pos), bool)
    mask[-17:] = False                               # a padded tail
    return pos, mask


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("float32"):
        return [np.asarray(a) for a in fn(*[jnp.asarray(a) for a in args], **kw)]


def _port(fn, *args, **kw):
    return [a.numpy() for a in fn(*[torch.from_numpy(a) for a in args], **kw)]


@pytest.mark.parametrize("band", [None, 32])
@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_knn_euclidean_matches_jax_slot_for_slot(kind, band):
    pos, mask = positions(kind)
    j_idx, j_dist, j_mask = _jax(jknn.knn_euclidean, pos, mask, k=8, band_window=band)
    t_idx, t_dist, t_mask = _port(knn.knn_euclidean, pos, mask, k=8, band_window=band)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_dist, j_dist)        # the same f32 rounding


def test_lattice_ties_are_many_and_keep_the_lower_index_first():
    """The lattice has exact ties (4 neighbours at one step); the first
    four of an interior node are its four lattice neighbours in index order."""
    pos, mask = positions("lattice")
    idx, dist, _ = _port(knn.knn_euclidean, pos, mask, k=8)
    i = 15 * 7 + 7                                  # an interior node
    assert len(set(dist[i, :4].tolist())) == 1
    assert list(idx[i, :4]) == sorted({i - 15, i - 1, i + 1, i + 15})


@pytest.mark.parametrize("band", [None, 32])
@pytest.mark.parametrize("case", ["placeholder5", "random14", "random64"])
def test_knn_cosine_matches_jax_slot_for_slot(case, band):
    pos, mask = positions("lattice")
    rs = np.random.RandomState(1)
    if case == "placeholder5":       # the builder's imageless features on a lattice
        n = len(pos)
        feats = np.concatenate([pos, np.ones((n, 1)), np.full((n, 1), 0.5),
                                np.zeros((n, 1))], 1).astype(np.float32)
    else:
        feats = rs.randn(len(pos), int(case[len("random"):])).astype(np.float32)
    j_idx, j_sim, j_mask = _jax(jknn.knn_cosine, feats, mask, k=16, band_window=band)
    t_idx, t_sim, t_mask = _port(knn.knn_cosine, feats, mask, k=16, band_window=band)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_mask, j_mask)
    if case == "placeholder5":
        np.testing.assert_array_equal(t_sim, j_sim)
    else:
        np.testing.assert_allclose(t_sim, j_sim, atol=1e-6, rtol=0)


@pytest.mark.parametrize("band", [None, 32])
def test_build_dual_knn_matches_jax(band):
    pos, mask = positions("lattice")
    feats = np.random.RandomState(2).randn(len(pos), 24).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = jknn.build_dual_knn(jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                                  k_spatial=8, k_morph=16, band_window=band)
    out = knn.build_dual_knn(torch.from_numpy(pos), torch.from_numpy(feats),
                             torch.from_numpy(mask), k_spatial=8, k_morph=16, band_window=band)
    for key in ("nbr_idx", "nbr_mask", "edge_type"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(out["edge_attr"].numpy(), np.asarray(ref["edge_attr"]),
                               atol=1e-6, rtol=0)
    assert out["nbr_idx"].dtype == torch.int32 and out["nbr_idx"].shape == (len(pos), 24)


def test_spatial_edge_weights_match_jax():
    dist = np.linspace(0.0, 1.5, 64, dtype=np.float32)
    j_w, j_keep = _jax(jknn.spatial_edge_weights, dist)
    t_w, t_keep = _port(knn.spatial_edge_weights, dist)
    np.testing.assert_array_equal(t_keep, j_keep)
    np.testing.assert_allclose(t_w, j_w, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_morton_keys_match_jax(kind):
    pos, mask = positions(kind)
    np.testing.assert_array_equal(morton_keys(pos, mask), jax_morton_keys(pos, mask))
    np.testing.assert_array_equal(morton_keys(pos, np.zeros_like(mask)),
                                  jax_morton_keys(pos, np.zeros_like(mask)))


def test_too_few_real_nodes_leave_masked_slots():
    pos, _ = positions("random")
    mask = np.zeros(len(pos), bool)
    mask[:5] = True
    idx, dist, valid = _port(knn.knn_euclidean, pos, mask, k=8)
    assert valid[:5].sum(1).tolist() == [4] * 5 and not valid[5:].any()
    assert (idx[~valid] == 0).all() and (dist[~valid] == 0).all()
