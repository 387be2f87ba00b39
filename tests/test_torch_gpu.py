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
#: The chunked backward's dk, dv on the card: their excess over half a
#: bf16 ulp of the dense route's values, 3× the largest measured on an
#: H100 (5.94e-8).
CHUNKED_CARD_ATOL = 1.8e-7
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
                                   "flash_attention": 0, "ssd_chunk": 0,
                                   "flash_train": 0}
    monkeypatch.setenv("REPRO_NO_FUSION", "1")
    ops.reset_launch_counts()
    _close_scaled(backend.execute(alg, operands), fused)
    assert ops.launch_counts() == {"gemm": 1, "syrk": 1, "symm": 0,
                                   "chain_gemm": 0, "gemm_syrk": 0,
                                   "flash_attention": 0, "ssd_chunk": 0,
                                   "flash_train": 0}


#: Families and points of the graph-timing tests: every kernel of the
#: sweep runs in one of their algorithms (abab's alg2 is gemm_syrk).
GRAPH_POINTS = [("aatb", (300, 200, 100)), ("abcd", (100, 300, 200, 150, 50)),
                ("abab", (300, 100, 200))]


def _step_launches(backend, alg, operands):
    """Kernel launches of one eager walk of ``alg``."""
    ops.reset_launch_counts()
    backend.execute(alg, operands)
    torch.cuda.synchronize()
    return {k: v for k, v in ops.launch_counts().items() if v}


@pytest.mark.parametrize("name,point", GRAPH_POINTS)
@pytest.mark.parametrize("backend_name", ["cuda", "torch"])
def test_graph_replay_matches_the_eager_walk(cuda, monkeypatch, backend_name,
                                             name, point):
    """A replayed graph gives the eager walk's result: bitwise, except
    where a kernel adds its l-chunks with atomics (chain_gemm, gemm_syrk;
    ROADMAP C1), which are held as PERF.md section 2 holds them."""
    from repro_torch.core.backends import get_backend, register_torch_backends
    from repro_torch.core.expressions import get_spec
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    register_torch_backends()
    backend = get_backend(backend_name, seed=0, reps=1)
    assert backend.timing == "graph"
    for alg in get_spec(name).algorithms(point):
        operands = backend.make_operands(alg)
        launched = _step_launches(backend, alg, operands)
        replayed = backend._timed_callable(alg, operands)().clone()
        walked = backend.execute(alg, operands)
        torch.cuda.synchronize()
        if launched.keys() & {"chain_gemm", "gemm_syrk"}:
            _close_scaled(replayed, walked)
        else:
            assert torch.equal(replayed, walked), alg.name


@pytest.mark.parametrize("name,point", GRAPH_POINTS)
@pytest.mark.parametrize("reps", [1, 3])
def test_graph_replays_are_credited_their_launches_exactly(cuda, monkeypatch,
                                                           name, point, reps):
    """time_algorithm on a memo miss: one eager walk, a capture (counted
    nothing), a warm-up replay and ``reps`` timed replays, so each step
    launches 2 + reps times; on a hit, the replays alone: 1 + reps."""
    from repro_torch.core.backends import CudaBackend
    from repro_torch.core.expressions import get_spec
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    backend = CudaBackend(seed=0, reps=reps)
    for alg in get_spec(name).algorithms(point):
        operands = backend.make_operands(alg)
        steps = _step_launches(backend, alg, operands)
        for executions in (2 + reps, 1 + reps):      # miss, then hit
            ops.reset_launch_counts()
            assert backend.time_algorithm(alg, operands) > 0
            got = {k: v for k, v in ops.launch_counts().items() if v}
            assert got == {k: n * executions for k, n in steps.items()}, \
                alg.name


def test_graph_memo_hits_only_for_the_same_inputs(cuda, monkeypatch):
    from repro_torch.core.backends import CudaBackend
    from repro_torch.core.expressions import get_spec
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    backend = CudaBackend(seed=0, reps=1)
    alg = get_spec("aatb").algorithms((300, 200, 100))[0]
    operands = backend.make_operands(alg)
    backend.time_algorithm(alg, operands)
    backend.time_algorithm(alg, operands)
    assert (backend.memo_hits, backend.memo_misses) == (1, 1)
    moved = {b: t.clone() for b, t in operands.items()}   # other pointers
    backend.time_algorithm(alg, moved)
    assert (backend.memo_hits, backend.memo_misses) == (1, 2)
    # Same structure and inputs, other dims: another graph.
    twin = next(a for a in get_spec("aatb").algorithms((200, 200, 100))
                if a.name == alg.name)
    backend.time_algorithm(twin, backend.make_operands(twin))
    assert backend.memo_misses == 3
    # The fusion switch is part of the key.
    monkeypatch.setenv("REPRO_NO_FUSION", "1")
    backend.time_algorithm(alg, operands)
    assert (backend.memo_hits, backend.memo_misses) == (1, 4)


def test_a_failed_capture_raises(cuda, monkeypatch):
    """No eager fallback: a kernel refused inside the capture surfaces."""
    from repro_torch.core.backends import CudaBackend, CudaOps
    from repro_torch.core.expressions import get_spec

    class Refused(CudaOps):
        calls = 0

        def gemm(self, a, b):
            Refused.calls += 1
            if Refused.calls > 1:   # the eager walk passes, the capture not
                raise RuntimeError("gemm: CUDA error 1 at launch")
            return super().gemm(a, b)

    backend = CudaBackend(seed=0, reps=1)
    monkeypatch.setattr(backend, "ops", Refused)
    alg = next(a for a in get_spec("aatb").algorithms((300, 200, 100))
               if a.name.startswith("alg3"))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        backend.time_algorithm(alg, backend.make_operands(alg))
    # The stream left capture mode: the card still runs work.
    torch.cuda.synchronize()
    assert float(torch.ones(4, device="cuda").sum()) == 4.0


def watched_fastpath_sweep(backend) -> None:
    """Sweep aatb over a 2³ grid through the pipelined fast path with
    ``backend`` watched: the helper thread synthesizes every operand on
    the host, and the timing thread places each on the device, outside
    every timed repetition (``_pre_rep`` to the ``_sync`` that stops the
    clock). The CPU tests run it on the CPU (tests/test_torch_fastpath.py)."""
    import threading

    from repro_torch.core.expressions import GridSpec, get_spec
    from repro_torch.core.sweep import sweep

    main = threading.get_ident()
    placed, synthesized, timing = [], [], {"rep": False}
    pre_rep, sync = backend._pre_rep, backend._sync
    asarray, synthesize = backend._asarray, backend.synthesize_leaf

    def watched_pre_rep():
        pre_rep()
        timing["rep"] = True

    def watched_sync(out):
        out = sync(out)
        timing["rep"] = False
        return out

    def watched_asarray(a):
        placed.append((threading.get_ident(), timing["rep"]))
        return asarray(a)

    def watched_synthesize(ref):
        synthesized.append(threading.get_ident())
        return synthesize(ref)

    backend._pre_rep, backend._sync = watched_pre_rep, watched_sync
    backend._asarray, backend.synthesize_leaf = (watched_asarray,
                                                 watched_synthesize)
    res = sweep(get_spec("aatb"), GridSpec.uniform((64, 128), 3).points(),
                runner=backend, fastpath=True)
    assert res.n_measured == 8 and res.fastpath.points_pipelined == 7
    assert placed and all(t == main and not rep for t, rep in placed)
    assert synthesized and all(t != main for t in synthesized)


def test_fast_path_places_no_operand_during_a_timed_repetition(cuda):
    from repro_torch.core.backends import CudaBackend
    watched_fastpath_sweep(CudaBackend(seed=0, reps=1))


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


def test_flash_attention_bf16_mha_at_olmoe_head_dim(cuda):
    """OLMoE's prefill case, cut to smoke size: MHA (H = Hkv), D = 128,
    bf16, causal."""
    _attention_case(cuda, 2, 4, 4, 384, 128, dict(causal=True), 20)


def _card_and_cpu(cuda, arch):
    import copy

    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_smoke(arch)
    cpu = api.init(cfg, seed=0, device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(cuda), api


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b",
                                  "mamba2_370m"])
def test_family_smoke_model_on_card_matches_cpu(cuda, arch):
    """A float32 smoke model of the moe or ssm family: prefill (S = 256
    takes flash once per attention layer; the SSM family launches no
    kernel) and three decode steps agree with the same weights on the
    CPU (plain version) at rtol = atol = 1e-4."""
    cfg, cpu, card, api = _card_and_cpu(cuda, arch)
    s = 64 if cfg.family == "ssm" else 256
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, s))
    ops.reset_launch_counts()
    got, caches = api.prefill(card, cfg, {"tokens": toks},
                              api.init_caches(card, cfg, 2, s + 4))
    assert ops.launch_counts()["flash_attention"] == (
        0 if cfg.family == "ssm" else cfg.n_layers)
    want, cpu_caches = api.prefill(cpu, cfg, {"tokens": toks},
                                   api.init_caches(cpu, cfg, 2, s + 4))
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    for i in range(3):
        step, caches = api.decode_step(card, cfg, toks[:, i:i + 1], caches)
        ref_step, cpu_caches = api.decode_step(cpu, cfg, toks[:, i:i + 1],
                                               cpu_caches)
        _close(step, ref_step, dict(rtol=1e-4, atol=1e-4))
    logits, aux = api.forward_train(card, cfg, {"tokens": toks[:, :64]})
    ref_logits, ref_aux = api.forward_train(cpu, cfg,
                                            {"tokens": toks[:, :64]})
    _close(logits, ref_logits, dict(rtol=1e-4, atol=1e-4))
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 * max(1.0,
                                                         float(ref_aux))


def test_moe_dispatches_agree_on_card(cuda):
    """gather and einsum dispatch, drops forced by capacity 0.25, on the
    card against each other and against the CPU."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_ff=96, n_experts=8, top_k=2,
                        capacity_factor=0.25)
    gen = torch.Generator().manual_seed(0)
    p = moe.MoE(cfg, generator=gen, device="cpu", dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 64))).float()
    want, _ = moe.apply(p, cfg, x)
    p.to(cuda)
    for dispatch in ("gather", "einsum"):
        got, _ = moe.apply(p, cfg._replace(dispatch=dispatch), x.to(cuda))
        _close(got, want, dict(rtol=1e-4, atol=1e-4))


def test_zamba2_smoke_generate_on_card_matches_cpu(cuda, monkeypatch):
    """The hybrid family on the card: generate past the 32-slot shared
    window equals the CPU's tokens, with no kernel launch."""
    from repro_torch.serve.decode import generate
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    cfg, cpu, card, api = _card_and_cpu(cuda, "zamba2_1p2b")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40))
    ops.reset_launch_counts()
    got = generate(card, cfg, prompt, max_new=6, max_s=48)
    assert not any(ops.launch_counts().values())
    want = generate(cpu, cfg, prompt, max_new=6, max_s=48)
    assert torch.equal(got.cpu(), want)


def test_whisper_smoke_decode_on_card_matches_cpu(cuda, monkeypatch):
    """The encdec family on the card: cross K/V from the encoder, eight
    decode steps and ``generate`` with frames equal the same weights on
    the CPU (logits at rtol = atol = 1e-4, identical tokens), with no
    kernel launch: cross-attention and the encoder's attention are
    masked dense, as in the reference."""
    from repro_torch.serve.decode import generate
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    cfg, cpu, card, api = _card_and_cpu(cuda, "whisper_tiny")
    rng = np.random.default_rng(4)
    frames = {"frames": rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    toks = rng.integers(0, cfg.vocab, (2, 8))
    ops.reset_launch_counts()
    caches = api.init_caches(card, cfg, 2, 16, batch_inputs=frames)
    cpu_caches = api.init_caches(cpu, cfg, 2, 16, batch_inputs=frames)
    _close(caches.cross_k.float(), cpu_caches.cross_k.float(),
           dict(rtol=2 ** -7, atol=1e-5))
    for i in range(8):
        step, caches = api.decode_step(card, cfg, toks[:, i:i + 1], caches)
        ref_step, cpu_caches = api.decode_step(cpu, cfg, toks[:, i:i + 1],
                                               cpu_caches)
        _close(step, ref_step, dict(rtol=1e-4, atol=1e-4))
    got = generate(card, cfg, toks, max_new=6, max_s=16, batch_inputs=frames)
    assert not any(ops.launch_counts().values())
    want = generate(cpu, cfg, toks, max_new=6, max_s=16, batch_inputs=frames)
    assert torch.equal(got.cpu(), want)


def test_vlm_smoke_prefill_runs_flash_and_matches_the_dense_route(cuda):
    """InternVL2's smoke model: a prefill of 8 vision positions and 248
    tokens (P + S = 256) launches flash once per layer and agrees with
    ``forward_train`` on the card (the dense route) and with the CPU at
    rtol = atol = 1e-4, over all P + S positions."""
    cfg, cpu, card, api = _card_and_cpu(cuda, "internvl2_76b")
    rng = np.random.default_rng(5)
    s = 256 - cfg.vision_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, s)),
             "vision_embeds": rng.standard_normal(
                 (2, cfg.vision_tokens, cfg.d_model)).astype(np.float32)}
    ops.reset_launch_counts()
    got, caches = api.prefill(card, cfg, batch,
                              api.init_caches(card, cfg, 2, 260))
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert got.shape == (2, 256, cfg.vocab) and int(caches.kv.length) == 256
    dense, _ = api.forward_train(card, cfg, batch)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    _close(got, dense, dict(rtol=1e-4, atol=1e-4))
    want, _ = api.prefill(cpu, cfg, batch, api.init_caches(cpu, cfg, 2, 260))
    _close(got, want, dict(rtol=1e-4, atol=1e-4))


def test_flash_attention_bf16_at_internvl2_head_layout(cuda):
    """InternVL2-76B's prefill case cut in length: 64 query heads over 8
    KV heads of 128, bf16, causal."""
    _attention_case(cuda, 1, 64, 8, 512, 128, dict(causal=True), 22)


# ------------------------------------------------ tuned launches (slice 9) --

#: (kind, dims) of the tuned-launch tests: ragged dims, each kind's
#: candidates at them all exercised.
TUNED_SHAPES = [("gemm", (333, 517, 401)), ("syrk", (333, 401)),
                ("symm", (333, 517)), ("chain_gemm", (333, 401, 517, 129)),
                ("gemm_syrk", (333, 401, 517))]


def _tuned_operands(kind, dims, rng, device):
    if kind == "gemm":
        m, n, k = dims
        return _mat(rng, m, k, device), _mat(rng, k, n, device)
    if kind == "syrk":
        return (_mat(rng, *dims, device),)
    if kind == "symm":
        m, n = dims
        return _mat(rng, m, m, device), _mat(rng, m, n, device)
    if kind == "chain_gemm":
        m, k, l, n = dims
        return (_mat(rng, m, k, device), _mat(rng, k, l, device),
                _mat(rng, l, n, device))
    m, k, l = dims
    return _mat(rng, m, k, device), _mat(rng, k, l, device)


@pytest.mark.parametrize("kind,dims", TUNED_SHAPES)
def test_tuned_launch_of_each_candidate_matches_plain(cuda, kind, dims):
    """Every launch the tuner may pick at ``dims`` — each table entry of
    ``candidate_configs``, resolved as dispatch resolves it — runs the
    kernel once and equals the plain version."""
    from repro_torch.core.tuning import (candidate_configs, card_limits,
                                         launch_config)
    rng = np.random.default_rng(len(dims) * 31 + dims[0])
    args = _tuned_operands(kind, dims, rng, cuda)
    want = getattr(ref, kind)(*args)
    limits = card_limits(cuda)
    for entry in candidate_configs(kind, dims):
        cfg = launch_config(kind, dims, entry, limits)
        assert cfg is not None, entry
        before = ops.launch_counts()[kind]
        got = getattr(ops, kind)(*args, config=cfg)
        assert ops.launch_counts()[kind] == before + 1
        torch.cuda.synchronize()
        if kind == "gemm_syrk":
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-2 + 1e-5 * scale
            assert not bool((torch.triu(got, 1) != 0).any())
        else:
            _close(got, want, CHAIN_TOL if kind == "chain_gemm" else TOL)


def test_graph_memo_replays_the_candidate_it_captured(cuda, monkeypatch):
    """Under ``tuning_override`` each candidate is captured in a graph of
    its own (the tuning generation is in the memo key) and a replay runs
    the launch it captured: two candidates at one set of pointers give
    two memo entries, the same candidate timed twice one; the launch each
    capture made is the candidate's."""
    from repro_torch.core.backends import CudaBackend, synthetic_algorithm
    from repro_torch.core.flops import KernelCall
    from repro_torch.core.tuning import candidate_configs, launch_config
    from repro_torch.kernels import gemm as gemm_mod
    monkeypatch.delenv("REPRO_NO_TUNING", raising=False)
    dims = (600, 500, 700)
    backend = CudaBackend(seed=0, reps=1, tuning=None)
    alg = synthetic_algorithm(KernelCall("gemm", dims))
    operands = backend.make_operands(alg)
    first, second = candidate_configs("gemm", dims)[:2]
    seen, launch = [], gemm_mod.launch

    def spy(a, b, cfg):
        seen.append(cfg)
        return launch(a, b, cfg)

    monkeypatch.setattr(gemm_mod, "launch", spy)
    outs = []
    for entry in (first, second):
        with backend.tuning_override({("gemm", dims): entry}):
            misses = backend.memo_misses
            backend.time_algorithm(alg, operands)
            backend.time_algorithm(alg, operands)
            assert backend.memo_misses == misses + 1
            outs.append(backend._timed_callable(alg, operands)().clone())
        want = launch_config("gemm", dims, entry)
        # The eager walk and the capture each called the wrapper once.
        assert seen[-2:] == [want, want]
    assert backend.memo_misses == 2
    expect = operands[0] @ operands[1]
    for out in outs:
        _close(out, expect, TOL)


def test_plan_service_execute_on_the_card_matches_the_plain_composition(
        cuda):
    """``PlanService`` on the ``cuda`` backend runs its plans through the
    hand kernels and agrees with the plain left-to-right product."""
    from repro_torch.core.expressions import get_spec
    from repro_torch.serve.plan_cache import PlanService
    svc = PlanService(backend="cuda", discriminant="perfmodel")
    for family, dims in (("aatb", (300, 200, 100)),
                         ("decmlp", (2, 256, 512)),
                         ("decattn", (1, 300, 64, 256))):
        plan = svc.lookup(family, dims)
        operands = svc.planner.runner.make_operands(plan.algorithm)
        args = [operands.get(b) for b in range(max(operands) + 1)]
        before = sum(ops.launch_counts().values())
        got = svc.execute(family, dims, *args)
        assert sum(ops.launch_counts().values()) > before
        want = get_spec(family).reference_value(dims, operands)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 + 1e-4 * scale
        assert svc.lookup(family, dims) is plan


def test_warmup_and_decode_consult_share_the_cards_plan_service(cuda):
    """``plan_warmup(device="cuda")`` and the consult made with a tensor's
    device (``cuda:0``) reach one default service: the consult hits."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.decode import plan_warmup
    from repro_torch.serve.plan_cache import (default_plan_service,
                                              reset_default_plan_service)
    cfg = configs.get_smoke("yi_9b")
    reset_default_plan_service()
    try:
        plan_warmup(cfg, 64, device="cuda")
        svc = default_plan_service("cuda")
        assert default_plan_service(torch.zeros(1, device="cuda").device) \
            is svc
        before = svc.cache.stats()
        transformer.init_caches(cfg, 1, 64, device="cuda")
        after = svc.cache.stats()
        assert (after["hits"] - before["hits"],
                after["misses"] - before["misses"]) == (1, 0)
    finally:
        reset_default_plan_service()


#: The ``torch`` backend on the card against ``blas`` (float64, the host),
#: max|d| <= limit·max|value|: float64 at 1e-10; bfloat16 at 2^-6
#: (PERF.md §2; inputs, intermediates and outputs rounded to bf16, the
#: products accumulated in float32).
PROTOCOL_TOL = {"float64": 1e-10, "bfloat16": 2 ** -6}


@pytest.mark.parametrize("dtype", sorted(PROTOCOL_TOL))
@pytest.mark.parametrize("name,point", [
    ("aatb", (1200, 800, 400)), ("abcd", (400, 1200, 400, 1200, 400)),
    ("aatb", (130, 70, 90))])
def test_torch_backend_on_the_card_matches_blas(cuda, dtype, name, point):
    from repro_torch.core.backends import get_backend, register_torch_backends
    from repro_torch.core.expressions import get_spec

    register_torch_backends()
    blas = get_backend("blas", reps=1, flush_cache=False, seed=0)
    card = get_backend("torch", dtype=dtype, seed=0)
    for alg in get_spec(name).algorithms(point):
        want = np.asarray(blas.execute(alg, blas.make_operands(alg)))
        got = card.execute(alg, card.make_operands(alg))
        assert got.is_cuda and got.dtype == card.torch_dtype
        err = float(np.abs(got.double().cpu().numpy() - want).max())
        assert err <= PROTOCOL_TOL[dtype] * float(np.abs(want).max()), \
            alg.name


def test_cuda_backend_refuses_bfloat16_on_the_card(cuda, capsys):
    from repro_torch.core import calibrate
    from repro_torch.core.backends import CudaBackend

    with pytest.raises(ValueError, match="float32"):
        CudaBackend(dtype="bfloat16")
    with pytest.raises(SystemExit) as exc:
        calibrate.main(["--backend", "cuda", "--dtype", "bfloat16",
                        "--grid", "tiny"])
    assert exc.value.code == 2
    assert "measures float32" in capsys.readouterr().err


def test_two_shard_blas_experiment1_on_the_cards_host(cuda, tmp_path):
    """Experiment 1 on blas over two spawned workers on the card's host
    draws the serial run's points."""
    import functools

    from repro_torch.core.backends import make_backend, register_torch_backends
    from repro_torch.core.experiments import experiment1_random_search
    from repro_torch.core.expressions import get_spec
    from repro_torch.core.sweep import AnomalyAtlas, atlas_path

    register_torch_backends()
    spec = get_spec("aatb")
    drawn = []
    for label, kw in (
            ("serial", dict(runner=make_backend("blas", reps=1, seed=0))),
            ("pool", dict(backend="process", shards=2,
                          runner_factory=functools.partial(
                              make_backend, "blas", reps=1, seed=0)))):
        fp = make_backend("blas", flush_cache=False).fingerprint()
        with AnomalyAtlas(atlas_path(spec.name, fp, 0.10, tmp_path / label),
                          fp, spec.name, 0.10) as atlas:
            res = experiment1_random_search(
                spec, box=(20, 200), n_anomalies=100, max_samples=20,
                seed=0, atlas=atlas, **kw)
            assert res.samples == 20
            drawn.append(sorted(r.point for r in atlas.records()))
    assert drawn[0] == drawn[1]


# ------------------------------------------------------------ training ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,hkv", [(0, 4), (300, 2)])
def test_chunked_core_on_the_card_matches_dense_autograd(cuda, dtype, window,
                                                         hkv):
    """``_ChunkedCore`` forward and backward on the card against autograd
    through the dense attention (the plain version): float32 out and dq
    at 1e-4 of the largest value, dk and dv (rounded to bf16 per key
    block) element by element within half a bf16 ulp of the summed query
    heads' dense values plus CHUNKED_CARD_ATOL; bf16 at 2**-6 of the
    largest value, as the flash kernel is held; no kernel launch. The
    core is called directly (``chunked_plain``): ``chunked_attention``
    takes the training kernels for bf16 on the card."""
    from repro_torch.models import attention

    cfg = attention.AttnConfig(d_model=256, n_heads=4, n_kv_heads=hkv,
                               head_dim=64, window=window)
    rng = np.random.default_rng(0)
    shapes = ((1, 2048, 4, 64), (1, 2048, hkv, 64), (1, 2048, hkv, 64),
              (1, 2048, 4, 64))
    q, k, v, g = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                               device=cuda, dtype=getattr(torch, dtype))
                  for s in shapes)
    group = 4 // hkv
    mha = cfg._replace(n_kv_heads=4)
    ops.reset_launch_counts()
    results = []
    for fn, c, kv in (
            (attention.chunked_plain, cfg, (k, v)),
            (attention._dense_attention, cfg, (k, v)),
            (attention._dense_attention, mha,
             [t.repeat_interleave(group, dim=2) for t in (k, v)])):
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, *kv))
        out = fn(c, qs, ks, vs)
        out.backward(g)
        results.append([t.detach().float() for t in (out, qs.grad, ks.grad,
                                            vs.grad)])
    assert not any(ops.launch_counts().values())
    got, want, heads = results
    for i in range(4):
        err = (got[i] - want[i]).abs()
        if dtype == "bfloat16" or i < 2:
            limit = 2 ** -6 if dtype == "bfloat16" else 1e-4
            assert float(err.max()) <= limit * float(want[i].abs().max()), i
            continue
        magnitude = heads[i].abs().unflatten(2, (hkv, group)).sum(3)
        excess = float((err - 2 ** -8 * magnitude).max())
        print(f"chunked {dtype} window {window} hkv {hkv}: "
              f"{'dk dv'.split()[i - 2]} over half a bf16 ulp {excess:.3e}")
        assert excess <= CHUNKED_CARD_ATOL, (i, excess)


#: Training's attention kernels: (B, S, H, D), Hkv, causal, window,
#: soft-cap, the scale of q and k (1.7 peaks the rows as chip_smoke.py's
#: flash check does; 4 puts the logits where a cap of 50 bends them).
FLASH_TRAIN_CASES = [
    ((1, 2048, 32, 128), 32, True, 0, 0.0, 1.0),      # zamba2_1p2b.train's
    ((1, 2048, 4, 64), 2, True, 300, 0.0, 1.7),
    ((1, 2048, 4, 64), 4, True, 300, 0.0, 1.7),
    ((1, 2048, 4, 64), 2, False, 300, 0.0, 1.7),
    ((1, 2048, 4, 64), 4, True, 0, 50.0, 4.0)]
#: The kernels' error may be at most this many times the plain core's.
FLASH_TRAIN_PLAIN_X = 1.5


@pytest.mark.parametrize("shape,hkv,causal,window,cap,qk", FLASH_TRAIN_CASES)
def test_flash_train_matches_dense_autograd_within_the_chunked_core(
        cuda, shape, hkv, causal, window, cap, qk):
    """``chunked_attention`` on bf16 operands takes the training kernels
    (4 launches, ``attention.train.kernel``): out, dq, dk and dv against
    float64 autograd of ``_dense_attention``, each within
    FLASH_TRAIN_PLAIN_X times the error of ``_ChunkedCore`` on the same
    bf16 inputs, relative to the largest value; two calls bit for bit."""
    from repro_torch.models import attention
    from repro_torch.runtime.spans import Recorder

    b, s, h, d = shape
    cfg = attention.AttnConfig(d_model=h * d, n_heads=h, n_kv_heads=hkv,
                               head_dim=d, causal=causal, window=window,
                               logit_softcap=cap)
    rng = np.random.default_rng(s + h + hkv + window)

    def draw(heads, scale=1.0):
        x = rng.standard_normal((b, s, heads, d)) * scale
        return torch.tensor(x, dtype=torch.float32, device=cuda).bfloat16()

    q, k, v, g = draw(h, qk), draw(hkv, qk), draw(hkv), draw(h)

    def vjp(fn, dtype):
        leaves = [t.to(dtype).detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(cfg, *leaves)
        out.backward(g.to(dtype))
        return [t.detach().double() for t in (out, *(x.grad for x in leaves))]

    want = vjp(attention._dense_attention, torch.float64)
    plain = vjp(attention.chunked_plain, torch.bfloat16)
    ops.reset_launch_counts()
    with Recorder() as rec:
        got = vjp(attention.chunked_attention, torch.bfloat16)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_train"] == 4
    assert dict(rec.counts) == {"attention.train.kernel": 1}
    again = vjp(attention.chunked_attention, torch.bfloat16)
    for name, gk, pl, w, ag in zip(("out", "dq", "dk", "dv"), got, plain,
                                   want, again):
        top = float(w.abs().max())
        err_k = float((gk - w).abs().max()) / top
        err_p = float((pl - w).abs().max()) / top
        print(f"flash_train {shape} hkv {hkv} causal {causal} window "
              f"{window} cap {cap}: {name} kernel {err_k:.3e} plain "
              f"{err_p:.3e} of max {top:.3e}")
        assert err_k <= FLASH_TRAIN_PLAIN_X * err_p, name
        assert torch.equal(gk, ag), name


def test_mamba2_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """Three float32 train steps of the mamba2 smoke config (AdamW) from the
    same weights on the card and on the CPU: the losses at rtol 1e-4 and
    the masters' distance over their update at 1e-2 (Adam's first step
    normalizes each gradient; the card sums in another order)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import train_step as ts

    cfg = configs.get_smoke("mamba2_370m")
    src = SyntheticLM(cfg.vocab, 64, 4, seed=0)
    runs = []
    for device in ("cpu", cuda):
        state = ts.make_train_state(cfg, seed=0, device="cpu")
        state.model.to(device)
        state = state._replace(params=dict(state.model.named_parameters()),
                               opt=ts.adamw.init(
                                   dict(state.model.named_parameters())),
                               step=state.step.to(device))
        start = {n: p.detach().cpu().clone() for n, p in state.params.items()}
        losses = []
        for step in range(3):
            state, m = ts.train_step(state, src.batch_at(step), cfg=cfg,
                                     peak_lr=1e-3, warmup=0, total_steps=10,
                                     compute_dtype=torch.float32)
            losses.append(float(m["loss"]))
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in state.params.items()}))
    (cpu_losses, cpu), (card_losses, card) = runs
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    num = sum(float((card[n] - cpu[n]).norm()) ** 2 for n in cpu)
    den = sum(float((cpu[n] - start[n]).norm()) ** 2 for n in cpu)
    assert (num / den) ** 0.5 <= 1e-2


# ---------------------------------------------------------- the batched path --

#: (kernel, dims) of the batched kernel checks: ragged shapes (no dim a
#: multiple of a tile) and the sweep's main-path shape at batch 8.
BATCHED_CASES = [
    ("gemm", (130, 70, 90)), ("gemm", (400, 1200, 400)),
    ("syrk", (130, 70)), ("syrk", (400, 800)),
    ("symm", (130, 70)), ("symm", (400, 800)),
    ("chain_gemm", (130, 70, 150, 60)), ("chain_gemm", (400, 400, 400, 400)),
    ("gemm_syrk", (130, 70, 90)), ("gemm_syrk", (400, 400, 800))]


def _batch(rng, b, r, c, cuda, view):
    """(b, r, c) operands: contiguous, a transposed view of (b, c, r), or
    rows cut from a buffer whose leading dim (c + 37) and instance stride
    are not multiples of 16 bytes."""
    if view == "t":
        return torch.from_numpy(rng.standard_normal((b, c, r))).float().to(
            cuda).mT
    if view == "ld":
        big = torch.from_numpy(rng.standard_normal((b, r, c + 37))).float()
        return big.to(cuda)[:, :, :c]
    return torch.from_numpy(rng.standard_normal((b, r, c))).float().to(cuda)


def _batched_call(kernel, dims, rng, b, cuda, view):
    """(kernel call, plain call) on batched operands of ``dims``."""
    if kernel == "gemm":
        m, k, n = dims
        a, bb = _batch(rng, b, m, k, cuda, view), _batch(rng, b, k, n, cuda, "")
        return (lambda: ops.gemm(a, bb)), (lambda: ref.gemm(a, bb))
    if kernel == "syrk":
        m, k = dims
        a = _batch(rng, b, m, k, cuda, view)
        return (lambda: ops.syrk(a)), (lambda: ref.syrk(a))
    if kernel == "symm":   # side R through views, garbage above S's diagonal
        m, n = dims
        s = _batch(rng, b, m, m, cuda, "")
        s = torch.tril(s) + torch.triu(s * 1e3, 1)
        y = _batch(rng, b, n, m, cuda, view)
        return (lambda: ops.symm(s, y.mT).mT), \
            (lambda: y @ ref.tri2full(torch.tril(s)))
    if kernel == "chain_gemm":
        m, k, l, n = dims
        a = _batch(rng, b, m, k, cuda, view)
        bb, c = _batch(rng, b, k, l, cuda, ""), _batch(rng, b, l, n, cuda, "t")
        return (lambda: ops.chain_gemm(a, bb, c)), \
            (lambda: ref.chain_gemm(a, bb, c))
    m, k, l = dims
    a, bb = _batch(rng, b, m, k, cuda, view), _batch(rng, b, k, l, cuda, "")
    return (lambda: ops.gemm_syrk(a, bb)), (lambda: ref.gemm_syrk(a, bb))


@pytest.mark.parametrize("kernel,dims", BATCHED_CASES)
@pytest.mark.parametrize("view", ["", "t", "ld"])
def test_batched_kernel_matches_plain(cuda, kernel, dims, view):
    """One launch for the batch, each instance within the kernel's
    tolerance of its plain version (PERF.md section 2)."""
    rng = np.random.default_rng(sum(dims) + len(view))
    run, plain = _batched_call(kernel, dims, rng, 8, cuda, view)
    before = ops.launch_counts()[kernel]
    out = run()
    assert ops.launch_counts()[kernel] == before + 1
    want = plain()
    assert out.shape == want.shape and out.shape[0] == 8
    for i in range(8):
        if kernel == "gemm_syrk":
            _close_scaled(out[i], want[i])
        else:
            _close(out[i], want[i],
                   CHAIN_TOL if kernel == "chain_gemm" else TOL)
    if kernel in ("syrk", "gemm_syrk"):
        assert bool((torch.triu(out, 1) == 0).all())


@pytest.mark.parametrize("m,k,n", [(130, 70, 90), (400, 1200, 400),
                                   (64, 400, 64)])
def test_batched_gemm_symm_syrk_every_launch_bitwise_per_instance(cuda, m, k,
                                                                   n):
    """Under one launch, instance i of a batch is bit for bit the
    unbatched launch on its operands (same code, same summation order),
    every tile and split included."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import symm as ksymm
    from repro_torch.kernels import syrk as ksyrk
    rng = np.random.default_rng(m + k + n)
    a = _batch(rng, 3, m, k, cuda, "t")
    b = _batch(rng, 3, k, n, cuda, "")
    s = torch.tril(_batch(rng, 3, m, m, cuda, ""))
    bs = _batch(rng, 3, m, n, cuda, "ld")
    for cfg in kgemm.candidates(k):
        got = kgemm.launch(a, b, cfg)
        for i in range(3):
            assert torch.equal(got[i], kgemm.launch(a[i], b[i], cfg)), cfg
        if cfg.bm == cfg.bn:
            got = ksyrk.launch(a, cfg)
            for i in range(3):
                assert torch.equal(got[i], ksyrk.launch(a[i], cfg)), cfg
    for cfg in kgemm.candidates(m):
        got = ksymm.launch(s, bs, cfg)
        for i in range(3):
            assert torch.equal(got[i], ksymm.launch(s[i], bs[i], cfg)), cfg


@pytest.mark.parametrize("kernel", ["gemm", "syrk", "symm", "chain_gemm",
                                    "gemm_syrk"])
def test_batched_kernel_past_the_grid_limit(cuda, kernel):
    """70,000 instances: the batch axis outnumbers the grid's y/z limit of
    65,535 and the kernel loops over the rest (gemm and symm with a split,
    so z holds 140,000 (instance, slice) pairs)."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import symm as ksymm
    from repro_torch.kernels import syrk as ksyrk
    rng = np.random.default_rng(70_000)
    batch = 70_000
    a = _batch(rng, batch, 8, 200, cuda, "")
    b = _batch(rng, batch, 200, 8, cuda, "")
    if kernel == "gemm":
        out, want = kgemm.launch(a, b, kgemm.with_split(2, 200, 2)), a @ b
    elif kernel == "syrk":
        out, want = ksyrk.launch(a, kgemm.with_split(2, 200, 2)), ref.syrk(a)
    elif kernel == "symm":
        s = torch.tril(_batch(rng, batch, 8, 8, cuda, ""))
        c = b[:, :8, :]
        out = ksymm.launch(s, c, kgemm.with_split(2, 8, 1))
        want = ref.symm(s, c)
    elif kernel == "chain_gemm":
        out, want = ops.chain_gemm(a, b, b.mT), ref.chain_gemm(a, b, b.mT)
    else:
        out, want = ops.gemm_syrk(a, b), ref.gemm_syrk(a, b)
    torch.cuda.synchronize()
    err = (out - want).abs().amax(dim=(1, 2))
    scale = want.abs().amax(dim=(1, 2))
    assert bool((err <= 1e-2 + 1e-5 * scale).all()), float(err.max())


GRAPH_BATCH_POINTS = [("aatb", (300, 200, 100)),
                      ("abcd", (200, 100, 300, 150, 250)),
                      ("abab", (300, 100, 200))]


@pytest.mark.parametrize("name,point", GRAPH_BATCH_POINTS)
def test_execute_batch_matches_execute_per_instance(cuda, monkeypatch, name,
                                                    point):
    from repro_torch.core.backends import CudaBackend
    from repro_torch.core.expressions import get_spec
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    backend = CudaBackend(seed=0, reps=1)
    for alg in get_spec(name).algorithms(point):
        operands = backend.make_batched_operands(alg, 4)
        got = backend.execute_batch(alg, operands)
        for i in range(4):
            want = backend.execute(alg, {k: v[i] for k, v in operands.items()})
            _close_scaled(got[i], want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("name,point", GRAPH_BATCH_POINTS)
@pytest.mark.parametrize("batch", [1, 32])
def test_batched_replay_launches_the_algorithms_steps(cuda, monkeypatch, name,
                                                      point, batch):
    """time_algorithm_batched on a memo miss: each kernel step launches
    2 + reps times (eager walk, warm-up replay, reps replays), whatever
    the batch: one launch a step for the whole batch."""
    from repro_torch.core.backends import CudaBackend
    from repro_torch.core.expressions import get_spec
    monkeypatch.delenv("REPRO_NO_FUSION", raising=False)
    backend = CudaBackend(seed=0, reps=2)
    for alg in get_spec(name).algorithms(point):
        steps = _step_launches(backend, alg, backend.make_operands(alg))
        operands = backend.make_batched_operands(alg, batch)
        ops.reset_launch_counts()
        assert backend.time_algorithm_batched(alg, operands=operands) > 0
        got = {k: v for k, v in ops.launch_counts().items() if v}
        assert got == {k: n * 4 for k, n in steps.items()}, alg.name


# ------------------------------------------------ the captured decode ---

def _eager_and_captured(cuda, arch, n_new=6):
    """One smoke model on the card (float32, seed 0) decoding a 6-token
    prompt (teacher-forced) and ``n_new`` greedy tokens twice from fresh
    caches: eagerly, the serve step driven in place as ``generate`` drives
    it, and through ``compile_serve_step``'s graph → ((tokens, logits of
    every step) eager, the same captured)."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve import decode
    cfg = configs.get_smoke(arch)
    model = api.init(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6))).to(cuda)
    inputs = None
    if cfg.family == "encdec":
        inputs = {"frames": rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    step = decode.make_serve_step(cfg)
    out = []
    for capture in (False, True):
        state = decode.ServeState(
            api.init_caches(model, cfg, 2, 16, batch_inputs=inputs),
            prompt[:, :1].clone(), None)
        if capture:
            compiled = decode.compile_serve_step(step, state, model)
            state = compiled.state
        tokens, logits = [], []
        for i in range(5 + n_new):
            if capture:
                nxt = compiled()
                logits.append(state.logits.clone())
            else:
                new, nxt = step(state, model)
                state.last_tokens.copy_(nxt)
                logits.append(new.logits)
            tokens.append(nxt.clone())
            if i < 5:
                state.last_tokens.copy_(prompt[:, i + 1:i + 2])
        out.append((torch.cat(tokens, 1), torch.stack(logits, 1)))
    return out


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b", "olmoe_1b_7b",
                                  "mamba2_370m", "zamba2_1p2b",
                                  "whisper_tiny", "internvl2_76b"])
def test_captured_serve_step_is_bitwise_the_eager_step(cuda, arch):
    """Every served family's smoke model: the graph's replays give the
    eager step's tokens and logits bit for bit (the same kernels on the
    same buffers), and launch no hand kernel."""
    ops.reset_launch_counts()
    (tok_e, log_e), (tok_c, log_c) = _eager_and_captured(cuda, arch)
    assert not any(ops.launch_counts().values())
    assert torch.equal(tok_c, tok_e)
    assert torch.equal(log_c, log_e)


def test_generate_captures_once_and_matches_the_eager_generate(
        cuda, monkeypatch):
    from repro_torch.serve import decode
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    cfg, _, card, _ = _card_and_cpu(cuda, "yi_9b")
    captures = []
    real = decode.compile_serve_step
    monkeypatch.setattr(decode, "compile_serve_step",
                        lambda *a: captures.append(1) or real(*a))
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (2, 9))
    got = decode.generate(card, cfg, prompt, max_new=7)
    assert len(captures) == 1
    want = decode.generate(card, cfg, prompt, max_new=7, capture=False)
    assert len(captures) == 1 and torch.equal(got, want)


def test_captured_sampling_draws_from_the_seeded_generator(cuda):
    """temperature > 0 under capture: the explicit generator is
    registered with the graph, so a seed gives the same tokens every run
    and another seed others."""
    from repro_torch.serve.decode import generate
    cfg, _, card, _ = _card_and_cpu(cuda, "gemma2_9b")
    prompt = np.random.default_rng(12).integers(0, cfg.vocab, (2, 4))
    runs = [generate(card, cfg, prompt, max_new=6, temperature=1.0,
                     seed=seed) for seed in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab


def test_a_capture_error_is_raised_not_swallowed(cuda, monkeypatch):
    """A step that reads a value on the host cannot be captured: the
    error reaches the caller of ``generate`` (no eager fallback), the
    card stays usable, and ``capture=False`` still runs the step."""
    from repro_torch.models import api
    from repro_torch.serve import decode
    cfg, _, card, _ = _card_and_cpu(cuda, "yi_9b")
    real = api.decode_step

    def host_read(model, cfg, tokens, caches):
        int(caches.kv.length)                      # a synchronising read
        return real(model, cfg, tokens, caches)

    monkeypatch.setattr(decode.api, "decode_step", host_read)
    with pytest.raises(RuntimeError):
        decode.generate(card, cfg, [[1, 2, 3]], max_new=2)
    torch.cuda.synchronize()
    out = decode.generate(card, cfg, [[1, 2, 3]], max_new=2, capture=False)
    assert out.shape == (1, 5)


def test_a_step_that_returns_new_caches_is_refused(cuda):
    """A step that rebuilds its caches instead of writing them in place
    would replay against stale state: the capture refuses it."""
    from repro_torch.models import api
    from repro_torch.serve import decode
    cfg, _, card, _ = _card_and_cpu(cuda, "yi_9b")
    step = decode.make_serve_step(cfg)

    def functional(state, params):
        new, nxt = step(state, params)
        kv = new.caches.kv
        return new._replace(caches=new.caches._replace(kv=kv._replace(
            length=kv.length + 0))), nxt

    state = decode.ServeState(api.init_caches(card, cfg, 1, 8),
                              torch.zeros((1, 1), dtype=torch.long,
                                          device=cuda), None)
    with pytest.raises(RuntimeError, match="stale state"):
        decode.compile_serve_step(functional, state, card)


# -------------------------------------------- the captured train step ---

def _train_both_ways(cuda, optimizer, remat, steps=3, mesh=None):
    """The mamba2 smoke config (``remat`` per block) from seed 0, ``steps``
    steps of 4 x 64 tokens twice: eagerly, and through
    ``compile_train_step``'s graph (the first step its eager warm-up, the
    others replays on batches copied into its static buffers) → [(rows of
    float metrics, final state, whether every state tensor kept its
    object and local storage)] eager, captured. On a ``mesh`` the state
    is sharded, the steps and the capture run under
    ``activation_sharding`` on ``shard_batch``'s batches, and each
    replay's batch is copied in as the loop copies it (``copy_batch``:
    this rank's rows into the static DTensor's local tensor)."""
    import contextlib
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(configs.get_smoke("mamba2_370m"), remat=remat)
    src = SyntheticLM(cfg.vocab, 64, 4, seed=0)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in
                src.batch_at(i).items()} for i in range(steps)]
    step = ts.make_train_step(cfg, optimizer=optimizer, peak_lr=1e-3,
                              warmup=1, total_steps=steps)
    sharding = (lambda: activation_sharding(mesh)) if mesh is not None \
        else contextlib.nullcontext
    runs = []
    for capture in (False, True):
        state = ts.make_train_state(cfg, optimizer=optimizer, seed=0,
                                    device=cuda, mesh=mesh)
        before = ts._fingerprint(state)
        rows = []
        for i, batch in enumerate(batches):
            if capture and i > 0:
                ts.copy_batch(compiled.batch, batch)
                m = compiled()
            else:
                with sharding():
                    batch = {k: shard_batch(v, mesh)
                             for k, v in batch.items()}
                    if capture:
                        compiled = ts.compile_train_step(step, state, batch)
                        m = compiled.first
                    else:
                        state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        runs.append((rows, state, ts._fingerprint(state) == before))
    return runs


def _captured_against_eager(eager, captured):
    assert [r["lr"] for r in captured] == [r["lr"] for r in eager]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in captured],
                                   [r[key] for r in eager], rtol=1e-5)
    assert all(np.isfinite(r["loss"]) for r in captured)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_captured_train_step_matches_the_eager_step(cuda, optimizer, remat):
    """Three steps both ways: lr bit for bit (the schedule of the device
    counter), losses and grad norms at rtol 1e-5 (eager backward passes
    on the card are not bitwise repeatable), the counters at 3 and no
    hand kernel launched."""
    ops.reset_launch_counts()
    (eager, s_e, _), (captured, s_c, kept) = _train_both_ways(
        cuda, optimizer, remat)
    assert kept
    assert not any(ops.launch_counts().values())
    _captured_against_eager(eager, captured)
    assert int(s_c.step) == int(s_e.step) == 3


def test_a_train_step_that_returns_new_state_is_refused(cuda):
    """A step that rebuilds its counter instead of advancing it in place
    would replay against stale state: the capture refuses it."""
    from repro_torch import configs
    from repro_torch.train import train_step as ts
    cfg = configs.get_smoke("mamba2_370m")
    step = ts.make_train_step(cfg)

    def functional(state, batch):
        new, m = step(state, batch)
        return new._replace(step=new.step + 0), m

    state = ts.make_train_state(cfg, seed=0, device=cuda)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32, device=cuda),
             "labels": torch.zeros((2, 16), dtype=torch.int32, device=cuda)}
    with pytest.raises(RuntimeError, match="stale state"):
        ts.compile_train_step(functional, state, batch)


def _nccl_world_of_one():
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


def test_captured_sharded_decode_matches_the_unsharded_capture(cuda):
    """Yi-9B smoke (float32) on the (1, 1) mesh of an NCCL world of one:
    the sharded serve step captured and replayed gives the tokens of the
    unsharded model's captured step from the same prefill."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.serve import decode
    from repro_torch.sharding.context import activation_sharding, \
        shard_batch
    cfg = configs.get_smoke("yi_9b")
    model = api.init(cfg, seed=0, device=cuda)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12))).to(cuda)

    def decode_captured(tokens, caches, steps=6):
        logits, caches = api.prefill(model, cfg, {"tokens": tokens}, caches)
        first = logits[:, -1].argmax(-1)[:, None]
        compiled = decode.compile_serve_step(
            decode.make_serve_step(cfg),
            decode.ServeState(caches, first, None), model)
        out = [first]
        for _ in range(steps):
            out.append(compiled().clone())
        return torch.cat(out, 1)

    init = lambda: api.init_caches(model, cfg, 2, 20,       # noqa: E731
                                   dtype=torch.float32)
    want = decode_captured(prompt, init())
    _nccl_world_of_one()
    try:
        mesh = make_host_mesh(model=1)
        specs.shard_model(model, cfg, mesh)
        with activation_sharding(mesh):
            got = decode_captured(shard_batch(prompt),
                                  specs.shard_caches(cfg, init(), mesh))
        got = got.full_tensor()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_captured_sharded_train_step_matches_the_eager_sharded_step(
        cuda, optimizer):
    """Mamba2 smoke on the (1, 1) mesh of an NCCL world of one: three
    steps captured (the warm-up, then replays that write the DTensors'
    local tensors in place) against three eager sharded steps: lr bit for
    bit, losses and grad norms at rtol 1e-5, no hand kernel launched."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_host_mesh
    _nccl_world_of_one()
    try:
        mesh = make_host_mesh(model=1)
        ops.reset_launch_counts()
        (eager, _, _), (captured, state, kept) = _train_both_ways(
            cuda, optimizer, "none", mesh=mesh)
        assert not any(ops.launch_counts().values())
        assert all(isinstance(p, DTensor) for p in state.params.values())
        assert int(state.step) == 3
    finally:
        dist.destroy_process_group()
    assert kept
    _captured_against_eager(eager, captured)


def test_train_loop_on_a_mesh_captures_and_restores(cuda, tmp_path,
                                                    monkeypatch):
    """``train_loop.train(mesh=...)`` on the card captures by default (one
    capture a run), and a run that crashed at step 3 resumes from its
    save at step 2 into the state it then captures: steps 2-4 as an
    uninterrupted captured run's at rtol 1e-5, lr bit for bit."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import loop as train_loop
    captures, real = [], train_loop.compile_train_step

    def counted(*args, **kw):
        captures.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(train_loop, "compile_train_step", counted)
    cfg = configs.get_smoke("mamba2_370m")
    source = SyntheticLM(cfg.vocab, 64, 4, seed=0)

    def run(ckpt=None, fail_at_step=None):
        rows = {}
        state = train_loop.train(
            cfg, source, 5, ckpt_dir=ckpt, save_every=2, peak_lr=1e-3,
            warmup=1, device=cuda, mesh=mesh, fail_at_step=fail_at_step,
            log_fn=lambda msg: None,
            on_step=lambda s, m, w: rows.__setitem__(s, m))
        return state, rows

    _nccl_world_of_one()
    try:
        mesh = make_host_mesh(model=1)
        _, whole = run()
        with pytest.raises(RuntimeError, match="injected failure"):
            run(str(tmp_path), fail_at_step=3)
        state, resumed = run(str(tmp_path))
        assert int(state.step) == 5
    finally:
        dist.destroy_process_group()
    assert len(captures) == 3
    assert sorted(resumed) == [2, 3, 4]
    _captured_against_eager([whole[s] for s in (2, 3, 4)],
                            [resumed[s] for s in (2, 3, 4)])


def test_captured_sharded_train_step_on_a_fake_world_of_four(cuda):
    """The mamba2 smoke step on the (2, 2) mesh of a fake world of four
    on the card: DTensor's multi-rank redistributions (gathers, reduce-
    scatters, the vocab-parallel loss) recorded in a real capture, held
    against the eager step on the same fake world: lr bit for bit and
    the local storage kept. The fake group's data is made up (a release
    whose fake collectives leave their outputs unwritten gives values of
    unwritten memory), so the losses and grad norms are compared, at
    rtol 1e-5, where they repeat: where the warm-up, an eager step on the
    eager run's first state and batch, gives its loss and grad norm bit
    for bit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        try:
            dist.all_reduce(torch.ones(1, device=cuda))
        except RuntimeError as e:
            pytest.skip(f"the fake process group refuses CUDA tensors: {e}")
        mesh = make_host_mesh(model=2, device_type="cuda")
        (eager, _, _), (captured, _, kept) = _train_both_ways(
            cuda, "adamw", "none", mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert kept
    assert [r["lr"] for r in captured] == [r["lr"] for r in eager]
    if all(np.isfinite(eager[0][k]) and captured[0][k] == eager[0][k]
           for k in ("loss", "grad_norm")):
        _captured_against_eager(eager, captured)


#: (B, nc, Q, H, P, G, N): one layer of the Mamba2-370M cell (chunk 256),
#: Zamba2-1.2B's Mamba2 blocks, the tiny presets, and a ragged Q (a
#: prefill's min(chunk, S)) with two groups and N of 48.
SSD_CHUNK_SHAPES = [(2, 8, 256, 32, 64, 1, 128), (1, 16, 128, 64, 64, 1, 64),
                    (2, 2, 32, 4, 32, 1, 16), (2, 3, 100, 4, 32, 2, 48)]


def _ssd_chunk_case(shape, device, seed=0):
    """x, Δt, B, C and A of a chunked SSD: x, B and C bf16 values (held
    in float32), Δt in [2⁻¹⁰, 2⁻³] and A in -1..-16 integer steps, so
    that Δt·A and its within-chunk cumsum are exact in float32 and every
    float32 quantity downstream is the kernel's own."""
    from repro_torch.models import ssm
    b, nc, q, h, p, g, n = shape
    gen = torch.Generator().manual_seed(seed)

    def bf16(*dims):
        return torch.randn(dims, generator=gen).bfloat16().float().to(device)
    x, bm, cm = bf16(b, nc, q, h, p), bf16(b, nc, q, g, n), bf16(b, nc, q, g, n)
    dt = (torch.randint(1, 129, (b, nc, q, h), generator=gen).float()
          / 1024).to(device)
    a = -(1 + torch.arange(h, device=device) % 16).float()
    return ssm, (x, dt, bm, cm, a)


def _intra_grads(stage, args, cotangents):
    """The stage's four outputs and the gradients of x, Δt, B and C."""
    leaves = [t.detach().clone().requires_grad_(True) for t in args[:4]]
    outs = stage(*leaves, args[4])
    grads = torch.autograd.grad(outs, leaves, [c.to(o.dtype) for c, o in
                                               zip(cotangents, outs)])
    return [o.detach() for o in outs[:2]] + list(grads)


@pytest.mark.parametrize("shape", SSD_CHUNK_SHAPES)
def test_ssd_chunk_kernel_holds_float32_precision(cuda, shape):
    """The kernel path (``_intra_kernel``: the fused kernel's forward and
    backward) against a float64 evaluation of ``_intra_chunks`` on the
    same inputs: y_intra, s_c and the gradients of x, Δt, B and C each
    within 4x the plain float32 path's own error and within 1e-5 of the
    largest entry (float32 x, B and C, which take the kernel's three-part
    route; the bf16 route computes the same numbers, the next test)."""
    ssm, args = _ssd_chunk_case(shape, cuda)
    f64 = [t.double() for t in args]
    gen = torch.Generator().manual_seed(1)
    outs = ssm._intra_chunks(*f64)
    cot = [torch.randn(o.shape, generator=gen).double().to(cuda)
           for o in outs]
    want = _intra_grads(ssm._intra_chunks, f64, cot)
    plain = _intra_grads(ssm._intra_chunks, args, cot)
    before = ops.launch_counts()["ssd_chunk"]
    got = _intra_grads(ssm._intra_kernel, args, cot)
    assert ops.launch_counts()["ssd_chunk"] == before + 4
    for name, k, p, w in zip(("y_intra", "s_c", "dx", "ddt", "dB", "dC"),
                             got, plain, want):
        err_k = float((k.double() - w).abs().max())
        err_p = float((p.double() - w).abs().max())
        top = float(w.abs().max())
        assert err_k <= 4 * err_p and err_k <= 1e-5 * top, (
            name, err_k, err_p, top)


@pytest.mark.parametrize("shape", SSD_CHUNK_SHAPES)
def test_ssd_chunk_bf16_route_computes_the_float32_routes_numbers(cuda,
                                                                  shape):
    """bf16 x, B and C (one exact part) give what the same values in
    float32 (three parts, two of them zero) give: y_intra, s_c and the
    float32 gradients bit for bit, dx, dB and dC as their bf16 rounding."""
    from repro_torch.kernels import ssd_chunk
    ssm, (x, dt, bm, cm, a) = _ssd_chunk_case(shape, cuda)
    cum = torch.cumsum(dt * a, dim=2)
    w = torch.exp(cum[:, :, -1:] - cum) * dt
    gen = torch.Generator().manual_seed(2)
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        xs, bs, cs = (t.to(dtype) for t in (x, bm, cm))
        y, s = ssd_chunk.intra(xs, bs, cs, dt, cum, w)
        if not runs:
            dy = torch.randn(y.shape, generator=gen).to(cuda)
            ds = torch.randn(s.shape, generator=gen).to(cuda)
        grads = ssd_chunk.backward(xs, bs, cs, dt, cum, w, y, dy, ds)
        runs.append((y, s, *grads))
    for f32, bf in zip(*runs):
        assert torch.equal(f32.to(bf.dtype), bf)


def test_ssd_chunk_kernel_is_deterministic(cuda):
    """Two forward and backward passes at the cell's shape give the same
    bits: every sum, the head sums of dB and dC included, has one order."""
    ssm, args = _ssd_chunk_case(SSD_CHUNK_SHAPES[0], cuda)
    x, dt, bm, cm, a = args
    args = (x.bfloat16(), dt, bm.bfloat16(), cm.bfloat16(), a)
    gen = torch.Generator().manual_seed(3)
    cot = [torch.randn(o.shape, generator=gen).to(cuda)
           for o in ssm._intra_chunks(*(t.float() for t in args[:4]), a)]
    first = _intra_grads(ssm._intra_kernel, args, cot)
    second = _intra_grads(ssm._intra_kernel, args, cot)
    for one, two in zip(first, second):
        assert torch.equal(one, two)


def test_ssd_chunk_kernel_captured_in_a_cuda_graph(cuda):
    """Forward and backward captured in a CUDA graph and replayed equal
    the eager call bit for bit; the capture counts the launches it
    records (one forward, three backward)."""
    ssm, args = _ssd_chunk_case(SSD_CHUNK_SHAPES[3], cuda)
    x, dt, bm, cm, a = args
    args = (x.bfloat16(), dt, bm.bfloat16(), cm.bfloat16(), a)
    gen = torch.Generator().manual_seed(4)
    cot = [torch.randn(o.shape, generator=gen).to(cuda)
           for o in ssm._intra_chunks(*(t.float() for t in args[:4]), a)]
    eager = _intra_grads(ssm._intra_kernel, args, cot)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _intra_grads(ssm._intra_kernel, args, cot)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()["ssd_chunk"]
    with torch.cuda.graph(graph):
        static = _intra_grads(ssm._intra_kernel, args, cot)
    assert ops.launch_counts()["ssd_chunk"] == before + 4
    graph.replay()
    torch.cuda.synchronize()
    for one, two in zip(eager, static):
        assert torch.equal(one, two)


def test_ssd_chunk_kernel_under_activation_sharding_on_a_mesh_of_one(cuda):
    """``ssd_chunked`` at a chunked shape inside ``activation_sharding`` on
    the (1, 1) mesh of an NCCL world of one, where ``local_map`` hands the
    kernel each rank's local chunk tensors: the output and the gradients
    of x, Δt, A, B and C equal the unsharded kernel call's, forward and
    backward launching the kernel once and three times."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm
    from repro_torch.sharding.context import activation_sharding, \
        replicate, shard_batch
    gen = torch.Generator().manual_seed(5)
    b, s, h, p, g, n, chunk = 2, 256, 4, 32, 1, 16, 64
    x, bm, cm = (torch.randn(dims, generator=gen).to(cuda, torch.bfloat16)
                 for dims in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    dt = (torch.rand((b, s, h), generator=gen) * 0.1 + 1e-3).to(cuda)
    a_log = torch.log(torch.linspace(1.0, 16.0, h)).to(cuda)
    dy = torch.randn((b, s, h, p), generator=gen).to(cuda, torch.bfloat16)

    def run(wrap):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, dt, a_log, bm, cm)]
        ops.reset_launch_counts()
        y = ssm.ssd_chunked(*(wrap(t, i) for i, t in enumerate(leaves)),
                            chunk=chunk)
        y = y.full_tensor() if hasattr(y, "full_tensor") else y
        grads = torch.autograd.grad(y, leaves, dy)
        return [y.detach(), *grads], ops.launch_counts()["ssd_chunk"]

    want, plain_launches = run(lambda t, i: t)
    _nccl_world_of_one()
    try:
        mesh = make_host_mesh(model=1)
        with activation_sharding(mesh):
            got, launches = run(lambda t, i: replicate(t) if i == 2
                                else shard_batch(t))
    finally:
        dist.destroy_process_group()
    assert plain_launches == launches == 4
    for name, one, two in zip(("y", "dx", "ddt", "da_log", "dB", "dC"), got,
                              want):
        assert not hasattr(one, "full_tensor"), name
        torch.testing.assert_close(one, two, rtol=1e-5, atol=1e-6,
                                   msg=name)
