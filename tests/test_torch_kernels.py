"""The port's kernel entry points against the JAX package's, on the CPU.

``repro_torch.kernels.ops`` runs each kernel's plain PyTorch version for
CPU tensors; ``repro.kernels.ops`` runs the Pallas kernels in interpret
mode here, as the reference's own tests do. Same numpy inputs into both;
float32 compares at rtol=1e-4, atol=1e-3, the chain and the fused
GEMM+SYRK at atol=1e-2 (their second contraction runs over larger values:
the fused product's diagonal is ~l·k), as in tests/test_kernels.py.
The CUDA kernels themselves are checked on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops

TOL = dict(rtol=1e-4, atol=1e-3)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-2)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x):
    """(reference input, port input) from one numpy array."""
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("m,k,n", [(130, 70, 200), (64, 64, 64), (1, 128, 3)])
@pytest.mark.parametrize("a_view,b_view", [(False, False), (True, False),
                                           (False, True)])
def test_gemm_matches_reference(m, k, n, a_view, b_view):
    rng = np.random.default_rng(m + n)
    a_store = _rand(rng, k, m) if a_view else _rand(rng, m, k)
    b_store = _rand(rng, n, k) if b_view else _rand(rng, k, n)
    a_np = a_store.T if a_view else a_store
    b_np = b_store.T if b_view else b_store
    a_t = torch.from_numpy(a_store).mT if a_view else torch.from_numpy(a_store)
    b_t = torch.from_numpy(b_store).mT if b_view else torch.from_numpy(b_store)
    want = np.asarray(jops.gemm(jnp.asarray(a_np), jnp.asarray(b_np)))
    np.testing.assert_allclose(ops.gemm(a_t, b_t).numpy(), want, **TOL)


@pytest.mark.parametrize("m,k", [(130, 70), (257, 33), (5, 1)])
def test_syrk_matches_reference(m, k):
    rng = np.random.default_rng(m * k)
    ja, ta = _both(_rand(rng, m, k))
    out = ops.syrk(ta).numpy()
    np.testing.assert_allclose(out, np.asarray(jops.syrk(ja)), **TOL)
    assert np.all(np.triu(out, 1) == 0.0)


@pytest.mark.parametrize("m,n", [(129, 33), (70, 130)])
def test_symm_matches_reference_and_ignores_upper_garbage(m, n):
    rng = np.random.default_rng(m + 3 * n)
    low = np.tril(_rand(rng, m, m))
    garbage = low + np.triu(_rand(rng, m, m) * 100, 1)
    js, ts = _both(garbage)
    jb, tb = _both(_rand(rng, m, n))
    out = ops.symm(ts, tb).numpy()
    np.testing.assert_allclose(out, np.asarray(jops.symm(js, jb)), **TOL)
    clean = ops.symm(torch.from_numpy(low), tb).numpy()
    np.testing.assert_allclose(out, clean, **TOL)


def test_symm_side_r_through_views_matches_reference():
    rng = np.random.default_rng(7)
    m, n = 90, 45
    low = np.tril(_rand(rng, m, m))
    b = _rand(rng, n, m)                      # B·S with B: n×m
    js, ts = _both(low)
    jb, tb = _both(b)
    want = np.asarray(jops.symm(js, jb.T)).T  # the reference's (S·Bᵀ)ᵀ
    got = ops.symm(ts, tb.mT).mT
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,k,l,n", [(130, 70, 150, 60), (65, 33, 200, 17)])
def test_chain_gemm_matches_reference(m, k, l, n):
    rng = np.random.default_rng(m + k + l + n)
    (ja, ta), (jb, tb), (jc, tc) = (_both(_rand(rng, *s)) for s in
                                    ((m, k), (k, l), (l, n)))
    np.testing.assert_allclose(ops.chain_gemm(ta, tb, tc).numpy(),
                               np.asarray(jops.chain_gemm(ja, jb, jc)),
                               **CHAIN_TOL)


@pytest.mark.parametrize("m,k,l,a_view", [(130, 70, 64, False),
                                           (256, 128, 128, False),
                                           (97, 45, 150, True)])
def test_gemm_syrk_matches_reference(m, k, l, a_view):
    rng = np.random.default_rng(m + k + l)
    a_store = _rand(rng, k, m) if a_view else _rand(rng, m, k)
    b = _rand(rng, k, l)
    a_np = a_store.T if a_view else a_store
    a_t = torch.from_numpy(a_store).mT if a_view else torch.from_numpy(a_store)
    out = ops.gemm_syrk(a_t, torch.from_numpy(b)).numpy()
    want = np.asarray(jops.gemm_syrk(jnp.asarray(a_np), jnp.asarray(b)))
    np.testing.assert_allclose(out, want, **CHAIN_TOL)
    assert out.shape == (m, m)
    assert np.all(np.triu(out, 1) == 0.0)
    # The fused pair equals the two kernels it replaces.
    two = ops.syrk(ops.gemm(a_t, torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(out, two, **CHAIN_TOL)


def test_tri2full_matches_reference():
    rng = np.random.default_rng(3)
    jt, tt = _both(_rand(rng, 70, 70))
    np.testing.assert_array_equal(ops.tri2full(tt).numpy(),
                                  np.asarray(jops.tri2full(jt)))


def test_shape_mismatches_raise_valueerror_naming_the_dim():
    z = torch.zeros
    with pytest.raises(ValueError, match=r"contraction dim k.*A.shape\[1\]=64"):
        ops.gemm(z(128, 64), z(128, 128))
    with pytest.raises(ValueError, match="symmetric dim m"):
        ops.symm(z(128, 100), z(128, 8))
    with pytest.raises(ValueError, match="symmetric dim m"):
        ops.symm(z(128, 128), z(100, 8))
    with pytest.raises(ValueError, match="contraction dim l"):
        ops.chain_gemm(z(8, 8), z(8, 100), z(99, 8))
    with pytest.raises(ValueError, match="contraction dim k"):
        ops.chain_gemm(z(8, 7), z(8, 100), z(100, 8))
    with pytest.raises(ValueError, match=r"gemm_syrk: contraction dim k.*"
                                         r"A.shape\[1\]=7"):
        ops.gemm_syrk(z(8, 7), z(8, 100))
    with pytest.raises(ValueError, match="must be a matrix"):
        ops.gemm_syrk(z(8, 7), z(7))
    with pytest.raises(ValueError, match="square dim"):
        ops.tri2full(z(8, 9))
    with pytest.raises(ValueError, match="must be a matrix"):
        ops.syrk(z(8))
    with pytest.raises(ValueError, match="must be float32"):
        ops.gemm(z(8, 8, dtype=torch.float64), z(8, 8))


def test_no_kernel_and_no_fallback_off_cpu_and_cuda():
    meta = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.gemm(meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        ops.gemm(meta, torch.zeros(8, 8))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = ops.launch_counts()
    a = torch.ones(4, 3)
    ops.gemm(a, a.mT)
    ops.syrk(a)
    ops.symm(torch.eye(4), a)
    ops.chain_gemm(a, a.mT, a)
    ops.gemm_syrk(a, a.mT)
    assert ops.launch_counts() == before
    assert set(before) == {"gemm", "syrk", "symm", "chain_gemm", "gemm_syrk"}


def test_build_without_nvcc_raises(monkeypatch):
    if _build.library_path().is_file() or \
            Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
