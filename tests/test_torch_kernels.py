"""The port's gather kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the Pallas kernels in interpret mode (as tests/test_pallas.py
runs them): ``gather_rows`` bit-equal in f32 and bf16, ``weighted_gather_sum``
within 1e-5 (an f32 sum of K terms in another order). The CUDA kernels are
held against the plain versions on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.ops.pallas.gather_agg import weighted_gather_sum as j_wgs
from dgdm_histopath_tpu.ops.pallas.gather_rows import gather_rows as j_gather_rows
from dgdm_histopath_torch.ops import kernels
from dgdm_histopath_torch.ops.kernels import build
from dgdm_histopath_torch.ops.kernels.gather_agg import (
    weighted_gather_sum,
    weighted_gather_sum_plain,
)
from dgdm_histopath_torch.ops.kernels.gather_rows import gather_rows, gather_rows_plain

DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _data(b=2, n=256, k=9, f=128, dtype="float32", seed=0, lo=0, hi=None):
    """src values representable in ``dtype``, so both frameworks see the same."""
    rs = np.random.RandomState(seed)
    tdt, _ = DT[dtype]
    src = torch.from_numpy(rs.randn(b, n, f).astype(np.float32)).to(tdt)
    idx = rs.randint(lo, n if hi is None else hi, size=(b, n, k)).astype(np.int32)
    w = rs.rand(b, n, k).astype(np.float32)
    return src, idx, w


def _jax(src, dtype):
    return jnp.asarray(src.float().numpy(), DT[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_bit_equal_to_pallas(dtype):
    src, idx, _ = _data(dtype=dtype)
    ref = j_gather_rows(_jax(src, dtype), jnp.asarray(idx), True)
    out = gather_rows(src, torch.from_numpy(idx))
    assert out.dtype == src.dtype and out.shape == (2, 256, 9, 128)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_gather_sum_plain_matches_pallas(dtype):
    src, idx, w = _data(dtype=dtype)
    ref = j_wgs(_jax(src, dtype), jnp.asarray(idx), jnp.asarray(w), True)
    out = weighted_gather_sum(src, torch.from_numpy(idx), torch.from_numpy(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_weighted_gather_sum_zero_weight_padding():
    src, idx, w = _data(n=256)
    w[:, 128:] = 0.0                        # padded tail: zero weight
    src[:, 200:] = 1e9                      # garbage padding features
    ref = j_wgs(_jax(src, "float32"), jnp.asarray(idx), jnp.asarray(w), True)
    out = weighted_gather_sum(src, torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(out[:, 128:], 0.0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_out_of_range_index_gives_zero_row_like_pallas():
    """Indices outside [0, N) match no one-hot column in the TPU kernels, so
    they give a zero row; the plain versions must agree (clamping would not)."""
    src, idx, w = _data(n=128, k=5, f=128, lo=-3, hi=131, seed=5)
    bad = (idx < 0) | (idx >= 128)
    assert bad.any()
    rows = gather_rows(src, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(rows[bad], 0.0)
    np.testing.assert_array_equal(rows, np.asarray(
        j_gather_rows(_jax(src, "float32"), jnp.asarray(idx), True)))
    agg = weighted_gather_sum(src, torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    ref = j_wgs(_jax(src, "float32"), jnp.asarray(idx), jnp.asarray(w), True)
    np.testing.assert_allclose(agg, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    src, idx, w = _data(b=1, n=100, k=5, f=24)
    before = kernels.launch_counts()
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    assert torch.equal(gather_rows(src, ti), gather_rows_plain(src, ti))
    assert torch.equal(weighted_gather_sum(src, ti, tw), weighted_gather_sum_plain(src, ti, tw))
    assert kernels.launch_counts() == before


BAD_INPUTS = {   # case -> (src, idx, w) transform, expected exception
    "src_dtype": (lambda s, i, w: (s.double(), i, w), TypeError),
    "idx_dtype": (lambda s, i, w: (s, i.long(), w), TypeError),
    "rank": (lambda s, i, w: (s[0], i[0], w[0]), ValueError),
    "batch": (lambda s, i, w: (s, i[:1], w[:1]), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    src, idx, w = _data(b=2, n=16, k=3, f=8)
    transform, exc = BAD_INPUTS[case]
    s, i, tw = transform(src, torch.from_numpy(idx), torch.from_numpy(w))
    with pytest.raises(exc):
        gather_rows(s, i)
    with pytest.raises(exc):
        weighted_gather_sum(s, i, tw)


def test_weighted_gather_sum_rejects_non_f32_weights():
    src, idx, w = _data(b=2, n=16, k=3, f=8)
    with pytest.raises(TypeError):
        weighted_gather_sum(src, torch.from_numpy(idx), torch.from_numpy(w).double())


def test_build_is_keyed_on_source_hash_and_needs_nvcc(monkeypatch, tmp_path):
    srcs = {s.stem: s for s in build.sources()}
    assert set(srcs) == {"gather_rows", "gather_agg", "gather_rows_bwd", "gather_agg_bwd",
                         "neighbor_transpose", "flash_spatial"}
    p = build.library_path(srcs["gather_rows"])
    assert p.parent == build.BUILD_DIR and p.name.startswith("gather_rows-")
    assert p == build.library_path(srcs["gather_rows"])
    other = tmp_path / "gather_rows.cu"
    other.write_text(srcs["gather_rows"].read_text() + "\n// changed\n")
    assert build.library_path(other).name != p.name
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()

