"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips where no CUDA device is present (the CPU
test run). On a machine with an H100 and ``nvcc``::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX (the card's machine has none); the parity with
the JAX reference is tested on the CPU in tests/test_torch_kernels.py and
tests/test_torch_sweep.py. Tolerance: float32 compares at rtol=1e-4,
atol=1e-3 (sums in another order), the fused chain at atol=1e-2 (its
atomics add partial sums in a varying order), as in tests/test_kernels.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-3)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mat(rng, r, c, device):
    return torch.from_numpy(rng.standard_normal((r, c))).float().to(device)


def _close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.parametrize("m,k,n", [
    (64, 64, 64), (1, 128, 128), (130, 70, 200), (129, 257, 130),
    (1200, 400, 1200), (1100, 333, 1037)])
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
def test_gemm_kernel(cuda, m, k, n, layout):
    rng = np.random.default_rng(m * 7 + n)
    a = _mat(rng, k, m, cuda).mT if layout[0] == "t" else _mat(rng, m, k, cuda)
    b = _mat(rng, n, k, cuda).mT if layout[1] == "t" else _mat(rng, k, n, cuda)
    before = ops.launch_counts()["gemm"]
    _close(ops.gemm(a, b), ref.gemm(a, b), TOL)
    assert ops.launch_counts()["gemm"] == before + 1


@pytest.mark.parametrize("m,k", [(64, 64), (130, 70), (257, 511),
                                 (1200, 800), (1100, 333), (1, 5)])
@pytest.mark.parametrize("transposed", [False, True])
def test_syrk_kernel(cuda, m, k, transposed):
    rng = np.random.default_rng(m + k)
    a = _mat(rng, k, m, cuda).mT if transposed else _mat(rng, m, k, cuda)
    out = ops.syrk(a)
    _close(out, ref.syrk(a), TOL)
    assert bool((torch.triu(out, 1) == 0).all())


@pytest.mark.parametrize("m,n", [(64, 64), (129, 33), (300, 120),
                                 (1200, 400), (1100, 333)])
def test_symm_kernel_ignores_upper_garbage(cuda, m, n):
    rng = np.random.default_rng(m * n)
    low = torch.tril(_mat(rng, m, m, cuda))
    garbage = low + torch.triu(_mat(rng, m, m, cuda) * 100, 1)
    b = _mat(rng, m, n, cuda)
    _close(ops.symm(garbage, b), ref.symm(low, b), TOL)
    # Side R through views: B·S = (S·Bᵀ)ᵀ.
    bt = _mat(rng, n, m, cuda)
    _close(ops.symm(garbage, bt.mT).mT, bt @ ref.tri2full(low), TOL)


@pytest.mark.parametrize("m,k,l,n", [
    (64, 64, 64, 64), (130, 70, 150, 60), (1200, 800, 1200, 400),
    (1100, 333, 1037, 555), (5, 3, 1, 2)])
def test_chain_gemm_kernel(cuda, m, k, l, n):
    rng = np.random.default_rng(m + l)
    a, b = _mat(rng, m, k, cuda), _mat(rng, k, l, cuda)
    c = _mat(rng, n, l, cuda).mT
    _close(ops.chain_gemm(a, b, c), ref.chain_gemm(a, b, c), CHAIN_TOL)


def test_every_algorithm_on_cuda_backend_matches_torch_backend(cuda):
    from repro_torch.core.backends import CudaBackend, TorchBackend
    from repro_torch.core.expressions import get_spec
    kernels = CudaBackend(seed=0)
    plain = TorchBackend(seed=0)
    ops.reset_launch_counts()
    for name, point in (("aatb", (130, 70, 200)),
                        ("abcd", (130, 70, 150, 60, 90))):
        for alg in get_spec(name).algorithms(point):
            operands = kernels.make_operands(alg)
            _close(kernels.execute(alg, operands),
                   plain.execute(alg, operands), CHAIN_TOL)
    assert all(v > 0 for v in ops.launch_counts().values())
