"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips where no CUDA device is present (the CPU
test run). On a machine with an H100 and ``nvcc``::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX (the card's machine has none); the parity with
the JAX reference is tested on the CPU in tests/test_torch_kernels.py and
tests/test_torch_sweep.py. Tolerance: float32 compares at rtol=1e-4,
atol=1e-3 (sums in another order), the fused chain at atol=1e-2 (its
second contraction runs over values ~sqrt(k) larger, and its atomics add
partial sums in a varying order), as in tests/test_kernels.py.
The fused GEMM+SYRK is held as chip_smoke.py holds it: max |kernel - plain|
<= 1e-2 + 1e-5·max|plain|. Its diagonal is ~l·k (3.2e5 at 1200·400·800)
while entries off it are ~sqrt(l)·k, so one element-wise atol cannot fit
both; float32 rounding of sums that large is ~1e-7 of the largest value
per term added, and the atomics add the l-chunks in a varying order.
Flash attention compares at rtol=atol=1e-4 in float32 and 2**-6 in
bfloat16 (outputs of magnitude ~1, one bfloat16 ulp is 2**-7; kernel and
plain version round p at different points), as in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-3)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-2)
#: The kernels the algorithm backends dispatch to (flash attention serves
#: the models).
SWEEP_KERNELS = ("gemm", "syrk", "symm", "chain_gemm", "gemm_syrk")


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


#: Shapes (m, k, n) at and across each boundary between the launch
#: configurations of ``gemm_config`` (tiles 128x128 / 128x64 / 64x64 and
#: contraction splits) on a 132-SM card, 1 x k and k x 1 edges included.
GEMM_CONFIG_SHAPES = [
    (1152, 40, 1152), (1024, 40, 1152), (640, 40, 1024), (640, 40, 960),
    (576, 600, 576), (512, 600, 512), (1025, 40, 1024), (1000, 40, 1000),
    (400, 1200, 400), (400, 255, 400), (400, 256, 400), (64, 4096, 64),
    (65, 1000, 33), (1, 700, 1), (1, 3000, 900), (900, 3000, 1),
    (700, 1, 700), (16, 17, 15), (400, 383, 400), (400, 384, 400),
    (256, 383, 768), (256, 600, 1200), (384, 800, 1024), (640, 1200, 800),
    (768, 1200, 1200)]


@pytest.mark.parametrize("m,k,n", [
    (64, 64, 64), (1, 128, 128), (130, 70, 200), (129, 257, 130),
    (1200, 400, 1200), (1100, 333, 1037)] + GEMM_CONFIG_SHAPES)
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
def test_gemm_kernel(cuda, m, k, n, layout):
    rng = np.random.default_rng(m * 7 + n)
    a = _mat(rng, k, m, cuda).mT if layout[0] == "t" else _mat(rng, m, k, cuda)
    b = _mat(rng, n, k, cuda).mT if layout[1] == "t" else _mat(rng, k, n, cuda)
    before = ops.launch_counts()["gemm"]
    _close(ops.gemm(a, b), ref.gemm(a, b), TOL)
    assert ops.launch_counts()["gemm"] == before + 1


@pytest.mark.parametrize("ld", [333, 1037])
@pytest.mark.parametrize("transposed", [False, True])
def test_gemm_kernel_unaligned_leading_dims(cuda, ld, transposed):
    """Operands cut from buffers whose rows are not 16-byte aligned."""
    rng = np.random.default_rng(ld)
    m, k, n = 300, 320, 290
    if transposed:   # A = Xᵀ, B = Yᵀ with X (k x ld), Y (n x ld)
        a = _mat(rng, k, ld, cuda)[:, :m].mT
        b = _mat(rng, n, ld, cuda)[:, :k].mT
    else:
        a = _mat(rng, m, ld, cuda)[:, :k]
        b = _mat(rng, k, ld, cuda)[:, :n]
    _close(ops.gemm(a, b), ref.gemm(a, b), TOL)


@pytest.mark.parametrize("m,k,n", [(400, 1200, 400), (1200, 400, 1200)])
def test_gemm_kernel_is_deterministic(cuda, m, k, n):
    """Split slices are summed in a fixed order: no atomics."""
    rng = np.random.default_rng(k)
    a, b = _mat(rng, m, k, cuda), _mat(rng, k, n, cuda)
    first = ops.gemm(a, b)
    assert torch.equal(first, ops.gemm(a, b))


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


#: (m, n) of the SYMM launches tested: main-path and sweep shapes, m not a
#: multiple of 16 (a ragged band), a single row, and shapes at each tile's
#: edge.
SYMM_SHAPES = [(1200, 400), (400, 800), (800, 1200), (1100, 333), (1037, 129),
               (200, 70), (77, 50), (129, 64), (17, 3), (1, 5), (256, 128)]


def _lower_with_garbage(rng, m, cuda):
    """(S with 1e3-scale garbage above the diagonal, its clean lower part)."""
    low = torch.tril(_mat(rng, m, m, cuda))
    return low + torch.triu(_mat(rng, m, m, cuda) * 1e3, 1), low


@pytest.mark.parametrize("m,n", SYMM_SHAPES)
@pytest.mark.parametrize("side", ["L", "R"])
def test_symm_kernel_every_launch(cuda, m, n, side):
    """Every tile and split symm_config can pick, forced through the
    launcher, on S with garbage above its diagonal; side R as (S·Bᵀ)ᵀ
    with Bᵀ a view."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import symm as ksymm
    rng = np.random.default_rng(m * 3 + n)
    s, low = _lower_with_garbage(rng, m, cuda)
    if side == "L":
        b = _mat(rng, m, n, cuda)
        want = ref.symm(low, b)
    else:
        y = _mat(rng, n, m, cuda)
        b = y.mT
        want = (y @ ref.tri2full(low)).mT
    assert ksymm.symm_config(m, n) in kgemm.candidates(m)
    for cfg in kgemm.candidates(m):
        before = ops.launch_counts()["symm"]
        _close(ksymm.launch(s, b, cfg), want, TOL)
        assert ops.launch_counts()["symm"] == before + 1


@pytest.mark.parametrize("ld", [333, 1037])
@pytest.mark.parametrize("side", ["L", "R"])
def test_symm_kernel_unaligned_leading_dims(cuda, ld, side):
    """S and B cut from buffers whose rows are not 16-byte aligned: every
    segment takes the 4-byte copies."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import symm as ksymm
    rng = np.random.default_rng(ld)
    m, n = 300, 290
    buf = _mat(rng, m, ld, cuda)
    s = torch.tril(buf[:, :m]) + torch.triu(buf[:, :m] * 1e3, 1)
    low = torch.tril(buf[:, :m])
    if side == "L":
        b = _mat(rng, m, ld, cuda)[:, :n]
        want = ref.symm(low, b)
    else:
        b = _mat(rng, n, ld, cuda)[:, :m].mT
        want = ref.tri2full(low) @ b
    for cfg in kgemm.candidates(m):
        _close(ksymm.launch(s, b, cfg), want, TOL)
    _close(ops.symm(s, b), want, TOL)


@pytest.mark.parametrize("m,n", [(1200, 400), (400, 1200), (1100, 333)])
def test_symm_kernel_is_deterministic(cuda, m, n):
    """No atomics: split slices are summed in slice order."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import symm as ksymm
    rng = np.random.default_rng(n)
    s, _ = _lower_with_garbage(rng, m, cuda)
    b = _mat(rng, m, n, cuda)
    for cfg in kgemm.candidates(m):
        assert torch.equal(ksymm.launch(s, b, cfg), ksymm.launch(s, b, cfg))


#: (m, k, l, n) of the chain launches tested: the main path's shape, sweep
#: shapes, m and l not multiples of 16, one l-chunk, degenerate edges.
CHAIN_SHAPES = [(1200, 800, 1200, 400), (400, 1200, 400, 400),
                (400, 400, 1200, 1200), (1100, 333, 1037, 555),
                (130, 70, 150, 60), (65, 33, 200, 17), (129, 16, 129, 129),
                (64, 64, 64, 64), (200, 40, 100, 3), (5, 3, 1, 2),
                (1, 7, 300, 1)]


@pytest.mark.parametrize("m,k,l,n", CHAIN_SHAPES)
def test_chain_kernel_every_piece(cuda, m, k, l, n):
    """Every piece chain_config can pick, forced through the launcher;
    C a transposed view."""
    from repro_torch.kernels import chain_gemm as kchain
    rng = np.random.default_rng(m + k + l + n)
    a, b = _mat(rng, m, k, cuda), _mat(rng, k, l, cuda)
    c = _mat(rng, n, l, cuda).mT
    want = ref.chain_gemm(a, b, c)
    assert kchain.chain_config(m, k, l, n) in kchain.CONFIGS
    for cfg in kchain.CONFIGS:
        before = ops.launch_counts()["chain_gemm"]
        _close(kchain.launch(a, b, c, cfg), want, CHAIN_TOL)
        assert ops.launch_counts()["chain_gemm"] == before + 1


@pytest.mark.parametrize("ld", [333, 1037])
def test_chain_kernel_unaligned_leading_dims(cuda, ld):
    from repro_torch.kernels import chain_gemm as kchain
    rng = np.random.default_rng(ld)
    m, k, l, n = 300, 200, 250, 190
    a = _mat(rng, m, ld, cuda)[:, :k]
    b = _mat(rng, l, ld, cuda)[:, :k].mT
    c = _mat(rng, l, ld, cuda)[:, :n]
    want = ref.chain_gemm(a, b, c)
    for cfg in kchain.CONFIGS:
        _close(kchain.launch(a, b, c, cfg), want, CHAIN_TOL)


def test_every_algorithm_on_cuda_backend_matches_torch_backend(cuda):
    from repro_torch.core.backends import CudaBackend, TorchBackend
    from repro_torch.core.expressions import get_spec
    kernels = CudaBackend(seed=0)
    plain = TorchBackend(seed=0)
    ops.reset_launch_counts()
    for name, point in (("aatb", (130, 70, 200)),
                        ("abcd", (130, 70, 150, 60, 90)),
                        ("abab", (130, 70, 90))):
        for alg in get_spec(name).algorithms(point):
            operands = kernels.make_operands(alg)
            _close(kernels.execute(alg, operands),
                   plain.execute(alg, operands), CHAIN_TOL)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in SWEEP_KERNELS), counts


def _close_scaled(got, want, atol=1e-2, rtol=1e-5):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert err <= atol + rtol * float(want.abs().max()), err


@pytest.mark.parametrize("m,k,l,a_view", [
    (1200, 400, 800, False), (1100, 333, 1037, True), (64, 64, 64, False),
    (130, 70, 90, False), (37, 50, 100, True), (5, 3, 7, False),
    (129, 1, 65, False), (70, 200, 1, False), (1, 5, 130, False)])
def test_gemm_syrk_kernel(cuda, m, k, l, a_view):
    rng = np.random.default_rng(m + k + l)
    a = _mat(rng, k, m, cuda).mT if a_view else _mat(rng, m, k, cuda)
    b = _mat(rng, k, l, cuda)
    before = ops.launch_counts()["gemm_syrk"]
    out = ops.gemm_syrk(a, b)
    _close_scaled(out, ref.gemm_syrk(a, b))
    assert bool((torch.triu(out, 1) == 0).all())
    assert ops.launch_counts()["gemm_syrk"] == before + 1
    # Launches on a dirty output still start from zero (memset each call).
    _close_scaled(ops.gemm_syrk(a, b), ref.gemm_syrk(a, b))


#: (m, k) of the SYRK launches tested: the main path's shape, sweep shapes,
#: m not a multiple of either tile, k not a multiple of 16, one row.
SYRK_SHAPES = [(1200, 800), (400, 1200), (1100, 333), (129, 257), (65, 17),
               (300, 1000), (1, 5), (200, 0)]


@pytest.mark.parametrize("m,k", SYRK_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_syrk_kernel_every_launch(cuda, m, k, transposed):
    """Every tile and split syrk_config can pick, forced through the
    launcher; A row-major or a transposed view. The strict upper triangle
    is exactly zero (written by the kernel or the summing pass)."""
    from repro_torch.kernels import syrk as ksyrk
    rng = np.random.default_rng(m + 3 * k)
    a = _mat(rng, k, m, cuda).mT if transposed else _mat(rng, m, k, cuda)
    want = ref.syrk(a)
    assert ksyrk.syrk_config(m, k) in ksyrk.syrk_candidates(k)
    for cfg in ksyrk.syrk_candidates(k):
        # Garbage in the allocator's cache where the output will land.
        torch.full((m, m), float("nan"), device=cuda)
        before = ops.launch_counts()["syrk"]
        out = ksyrk.launch(a, cfg)
        _close(out, want, TOL)
        assert bool((torch.triu(out, 1) == 0).all()), cfg
        assert ops.launch_counts()["syrk"] == before + 1


@pytest.mark.parametrize("m,k", [(1200, 800), (400, 400), (1100, 333)])
def test_syrk_kernel_is_deterministic(cuda, m, k):
    """No atomics: split slices are summed in slice order."""
    from repro_torch.kernels import syrk as ksyrk
    rng = np.random.default_rng(k)
    a = _mat(rng, m, k, cuda)
    for cfg in ksyrk.syrk_candidates(k):
        assert torch.equal(ksyrk.launch(a, cfg), ksyrk.launch(a, cfg)), cfg


#: (m, k, l) of the fused GEMM+SYRK launches tested: the main path's shape,
#: sweep shapes, m, k and l off every tile, l below and off the chunk width.
GEMM_SYRK_SHAPES = [(1200, 400, 800), (400, 400, 400), (1100, 333, 1037),
                    (130, 70, 90), (37, 50, 100), (200, 17, 33), (65, 64, 15)]


@pytest.mark.parametrize("m,k,l", GEMM_SYRK_SHAPES)
def test_gemm_syrk_kernel_every_launch(cuda, m, k, l):
    """Every (chunk width, cluster size) gemm_syrk_config can pick, forced
    through the launcher, each on an output whose memory held NaNs; A a
    transposed view."""
    from repro_torch.kernels import gemm_syrk as kfused
    rng = np.random.default_rng(m + k + l)
    a, b = _mat(rng, k, m, cuda).mT, _mat(rng, k, l, cuda)
    want = ref.gemm_syrk(a, b)
    assert kfused.gemm_syrk_config(m, k, l) in kfused.candidates(m)
    for cfg in kfused.candidates(m):
        torch.full((m, m), float("nan"), device=cuda)
        before = ops.launch_counts()["gemm_syrk"]
        out = kfused.launch(a, b, cfg)
        _close_scaled(out, want)
        assert bool((torch.triu(out, 1) == 0).all()), cfg
        assert ops.launch_counts()["gemm_syrk"] == before + 1


def test_gemm_syrk_every_launch_is_schedulable(cuda):
    """Each launch the rule may make at the paper's largest m has room for
    at least one cluster on the card."""
    from repro_torch.kernels import gemm_syrk as kfused
    for cfg in kfused.candidates(1200):
        assert kfused.max_active_clusters(1200, cfg) >= 1, cfg


def test_gemm_syrk_kernel_at_the_largest_m_it_holds(cuda):
    """At max_m() only the narrowest chunk over the largest cluster fits,
    and the fused kernel runs there."""
    from repro_torch.kernels import gemm_syrk as kfused
    m, k, l = kfused.max_m(), 24, 40
    assert [c.name for c in kfused.candidates(m)] == ["bl16 c8"]
    rng = np.random.default_rng(1)
    a, b = _mat(rng, m, k, cuda), _mat(rng, k, l, cuda)
    ops.reset_launch_counts()
    out = ops.gemm_syrk(a, b)
    assert ops.launch_counts()["gemm_syrk"] == 1
    _close_scaled(out, ref.gemm_syrk(a, b))


def test_gemm_syrk_beyond_the_largest_m_runs_gemm_and_syrk(cuda):
    """One row more than max_m(): no launch holds the panel, so the
    wrapper runs the port's gemm and syrk kernels, as the reference falls
    back above its VMEM bound."""
    from repro_torch.kernels import gemm_syrk as kfused
    m, k, l = kfused.max_m() + 1, 24, 40
    assert kfused.gemm_syrk_config(m, k, l) is None
    rng = np.random.default_rng(2)
    a, b = _mat(rng, m, k, cuda), _mat(rng, k, l, cuda)
    ops.reset_launch_counts()
    out = ops.gemm_syrk(a, b)
    counts = ops.launch_counts()
    assert (counts["gemm"], counts["syrk"], counts["gemm_syrk"]) == (1, 1, 0)
    _close_scaled(out, ref.gemm_syrk(a, b))
    assert bool((torch.triu(out, 1) == 0).all())


def test_every_family_on_cuda_backend_matches_torch_backend(cuda,
                                                             monkeypatch):
    from repro_torch.core.backends import CudaBackend, TorchBackend
    from repro_torch.core.expressions import get_spec, registered_names
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    kernels = CudaBackend(seed=0)
    plain = TorchBackend(seed=0)
    ops.reset_launch_counts()
    for name in registered_names():
        spec = get_spec(name)
        point = spec.grid("small").points()[-2]
        for alg in spec.algorithms(point):
            operands = kernels.make_operands(alg)
            _close_scaled(kernels.execute(alg, operands),
                          plain.execute(alg, operands), rtol=1e-4)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in SWEEP_KERNELS), counts


def test_abab_alg2_without_fusion_launches_gemm_and_syrk(cuda, monkeypatch):
    from repro_torch.core.backends import CudaBackend
    from repro_torch.core.expressions import get_spec
    backend = CudaBackend(seed=0)
    (alg,) = [a for a in get_spec("abab").algorithms((300, 100, 200))
              if a.name == "alg2[gemm+syrk+tri2full]"]
    operands = backend.make_operands(alg)
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    ops.reset_launch_counts()
    fused = backend.execute(alg, operands)
    assert ops.launch_counts() == {"gemm": 0, "syrk": 0, "symm": 0,
                                   "chain_gemm": 0, "gemm_syrk": 1,
                                   "flash_attention": 0}
    monkeypatch.setenv("REPRO_NO_FUSION", "1")
    ops.reset_launch_counts()
    _close_scaled(backend.execute(alg, operands), fused)
    assert ops.launch_counts() == {"gemm": 1, "syrk": 1, "symm": 0,
                                   "chain_gemm": 0, "gemm_syrk": 0,
                                   "flash_attention": 0}


ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2 ** -6, atol=2 ** -6)}
#: Scale of q and k, as in chip_smoke.py: logits of standard deviation
#: ~2.9, so each row's softmax is peaked and outputs are O(1); at a scale
#: of 0.3 rows are near uniform and a dropped key tile can pass ATTN_TOL.
QK_SCALE = 1.7


@pytest.mark.parametrize("b,h,hkv,s,d,dtype,kwargs", [
    (2, 4, 2, 256, 64, torch.float32, dict(causal=True)),
    (2, 4, 2, 256, 64, torch.float32, dict(causal=False)),
    (2, 4, 2, 256, 64, torch.float32, dict(logit_softcap=30.0)),
    (2, 4, 2, 256, 64, torch.float32, dict(window=128)),
    (2, 4, 2, 256, 64, torch.float32, dict(window=64, logit_softcap=20.0)),
    (1, 2, 2, 384, 32, torch.float32, dict()),
    (1, 8, 2, 1000, 96, torch.float32, dict(causal=False)),
    (1, 4, 4, 70, 16, torch.float32, dict(causal=False, window=20)),
    (2, 32, 4, 512, 128, torch.bfloat16, dict()),
    (1, 16, 8, 640, 256, torch.bfloat16, dict(window=300,
                                               logit_softcap=50.0)),
    (1, 4, 2, 333, 256, torch.float32, dict()),
    (1, 4, 1, 1, 128, torch.bfloat16, dict()),
])
def test_flash_attention_kernel(cuda, b, h, hkv, s, d, dtype, kwargs):
    rng = np.random.default_rng(b * h + s + d)

    def heads(n, scale):   # (B, S, n, D) buffer seen as (B, n, S, D)
        x = rng.standard_normal((b, s, n, d)) * scale
        return torch.from_numpy(x).to(dtype).to(cuda).transpose(1, 2)

    q, k, v = heads(h, QK_SCALE), heads(hkv, QK_SCALE), heads(hkv, 1.0)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, **kwargs)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.shape == (b, h, s, d) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()
    want = ref.flash_attention(q, k, v, **kwargs)
    _close(out.float(), want.float(), ATTN_TOL[dtype])


def _heads(rng, b, s, n, d, dtype, device, scale):
    """A (B, S, n, D) buffer seen as (B, n, S, D), as the model's views."""
    x = rng.standard_normal((b, s, n, d)) * scale
    return torch.from_numpy(x).to(dtype).to(device).transpose(1, 2)


def _attention_case(cuda, b, h, hkv, s, d, kwargs, seed):
    rng = np.random.default_rng(seed)
    dt = torch.bfloat16
    q = _heads(rng, b, s, h, d, dt, cuda, QK_SCALE)
    k = _heads(rng, b, s, hkv, d, dt, cuda, QK_SCALE)
    v = _heads(rng, b, s, hkv, d, dt, cuda, 1.0)
    from repro_torch.kernels import flash_attention as flash
    before, copies = ops.launch_counts()["flash_attention"], flash.copies
    out = ops.flash_attention(q, k, v, **kwargs)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert flash.copies == copies   # the model's views are read in place
    assert out.shape == (b, h, s, d) and out.dtype == dt
    _close(out.float(), ref.flash_attention(q, k, v, **kwargs).float(),
           ATTN_TOL[dt])
    return q, k, v, out


@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_every_head_dim(cuda, d, causal):
    _attention_case(cuda, 2, 4, 2, 320, d, dict(causal=causal), d)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kwargs", [
    dict(window=128), dict(window=64), dict(window=100), dict(window=1),
    dict(causal=False, window=128), dict(causal=False, window=100),
    dict(logit_softcap=30.0), dict(window=100, logit_softcap=50.0)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_flash_attention_bf16_windows_and_softcap(cuda, d, kwargs):
    """Windows at a tile boundary (64, 128) and off it (100, 1)."""
    _attention_case(cuda, 1, 4, 4, 512, d, kwargs, d + kwargs.get("window", 0))


@pytest.mark.parametrize("hkv", [8, 4, 2, 1])
def test_flash_attention_bf16_gqa_groups(cuda, hkv):
    _attention_case(cuda, 2, 8, hkv, 256, 128, dict(causal=True), hkv)


@pytest.mark.parametrize("s", [1, 70, 200, 333, 1000])
@pytest.mark.parametrize("d", [96, 128, 256])
def test_flash_attention_bf16_ragged_seq(cuda, s, d):
    """S that is no multiple of the 128-row query or the K/V tile."""
    _attention_case(cuda, 1, 4, 2, s, d, dict(causal=True), s + d)
    _attention_case(cuda, 1, 4, 2, s, d, dict(causal=False, window=50), s)


def test_flash_attention_bf16_is_deterministic(cuda):
    q, k, v, out = _attention_case(cuda, 2, 8, 2, 640, 128,
                                   dict(causal=True), 0)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=True))


def test_flash_attention_bf16_check_rejects_a_dropped_key_tile(cuda):
    """The kernel passes ATTN_TOL and the plain version with one fully
    visible 32-key tile dropped does not: the inputs are sharp enough for
    the check to see a tile-level fault."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    q, k, v, out = _attention_case(cuda, 1, 8, 2, 1024, 128,
                                   dict(causal=True), 5)
    planted = cs.attention_hiding_keys(torch, q, k, v, 512, 544)
    with pytest.raises(AssertionError):
        _close(out.float(), planted.float(), ATTN_TOL[torch.bfloat16])


def test_flash_attention_bf16_copies_only_unaligned_views(cuda):
    """A view whose rows are not 16-byte aligned is copied once, counted,
    and gives the same result as the aligned data."""
    from repro_torch.kernels import flash_attention as flash
    rng = np.random.default_rng(7)
    b, h, s, d = 1, 4, 200, 64
    buf = torch.from_numpy(rng.standard_normal((b, s, h, d + 1))
                           * QK_SCALE).to(torch.bfloat16).to(cuda)
    q = buf[..., :d].transpose(1, 2)     # row stride H·(D+1): not 16-byte
    k = _heads(rng, b, s, h, d, torch.bfloat16, cuda, QK_SCALE)
    v = _heads(rng, b, s, h, d, torch.bfloat16, cuda, 1.0)
    assert not flash.reads_in_place(q) and flash.reads_in_place(k)
    copies = flash.copies
    out = ops.flash_attention(q, k, v)
    assert flash.copies == copies + 1
    assert torch.equal(out, ops.flash_attention(q.contiguous(), k, v))
    _close(out.float(), ref.flash_attention(q, k, v).float(),
           ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b", "phi3_mini"])
def test_smoke_model_prefill_on_card_runs_flash_and_matches_cpu(cuda, arch):
    """A float32 smoke model: prefill at S=256 launches the kernel once per
    layer and agrees with the same weights on the CPU (plain version)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_smoke(arch)
    cpu = api.init(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 256))
    ops.reset_launch_counts()
    got, caches = api.prefill(card, cfg, {"tokens": toks},
                              api.init_caches(card, cfg, 2, 260))
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = api.prefill(cpu, cfg, {"tokens": toks},
                          api.init_caches(cpu, cfg, 2, 260))
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    step, _ = api.decode_step(card, cfg, toks[:, :1], caches)
    assert step.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(step).all())
