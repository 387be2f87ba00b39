"""The port's kernel entry points against the JAX package's, on the CPU.

``repro_torch.kernels.ops`` runs each kernel's plain PyTorch version for
CPU tensors; ``repro.kernels.ops`` runs the Pallas kernels in interpret
mode here, as the reference's own tests do. Same numpy inputs into both;
float32 compares at rtol=1e-4, atol=1e-3, the chain and the fused
GEMM+SYRK at atol=1e-2 (their second contraction runs over larger values:
the fused product's diagonal is ~l·k), as in tests/test_kernels.py;
flash attention at rtol=atol=1e-4 in float32 (as the reference's own
flash tests) and rtol=atol=2**-6 in bfloat16: outputs are weighted means
of values of magnitude ~1, where one bfloat16 ulp is 2**-7, and the two
sides round p at different points (the kernel before normalising, the
reference after) and round the output once each.
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
    q = torch.ones(1, 2, 5, 16)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == before
    assert set(before) == {"gemm", "syrk", "symm", "chain_gemm", "gemm_syrk",
                           "flash_attention", "ssd_chunk", "flash_train"}


def test_build_without_nvcc_raises(monkeypatch):
    if _build.library_path().is_file() or \
            Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ------------------------------------------------------- flash attention ---

ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)


def _attention_inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, h, s, d) * 0.3, _rand(rng, b, hkv, s, d) * 0.3,
            _rand(rng, b, hkv, s, d))


@pytest.mark.parametrize("kwargs", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, logit_softcap=30.0),
    dict(causal=True, window=128),
    dict(causal=True, window=64, logit_softcap=20.0),
])
def test_flash_attention_matches_reference_variants(kwargs):
    q, k, v = _attention_inputs(11, 2, 4, 2, 256, 64)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kwargs)
    assert got.shape == (2, 4, 256, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("b,h,hkv,s,d,kwargs", [
    (1, 2, 2, 384, 32, dict()),                       # MHA, no GQA
    (1, 2, 1, 100, 32, dict(causal=False)),           # ragged S
    (1, 4, 2, 200, 96, dict(window=50)),              # phi3's head_dim
])
def test_flash_attention_matches_reference_shapes(b, h, hkv, s, d, kwargs):
    q, k, v = _attention_inputs(b + h + s, b, h, hkv, s, d)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kwargs)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_flash_attention_bf16_matches_reference():
    q, k, v = _attention_inputs(5, 1, 4, 2, 256, 32)
    to_j = lambda x: jnp.asarray(x, dtype=jnp.bfloat16)
    to_t = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    kwargs = dict(causal=True, window=96, logit_softcap=50.0)
    want = jops.flash_attention(to_j(q), to_j(k), to_j(v), **kwargs)
    got = ops.flash_attention(to_t(q), to_t(k), to_t(v), **kwargs)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **ATTN_BF16_TOL)


def test_flash_attention_reads_strided_views():
    """The model passes (B, S, H, D) buffers as (B, H, S, D) views."""
    q, k, v = _attention_inputs(9, 2, 4, 2, 130, 16)
    views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
             .transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    dense = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_array_equal(ops.flash_attention(*views).numpy(),
                                  dense.numpy())


def test_flash_attention_bad_head_dim_and_heads_raise_valueerror():
    z = torch.zeros
    with pytest.raises(ValueError, match=r"head_dim D=48 is not one of"):
        ops.flash_attention(z(1, 2, 8, 48), z(1, 2, 8, 48), z(1, 2, 8, 48))
    with pytest.raises(ValueError, match=r"mismatched heads: H=6.*Hkv=4"):
        ops.flash_attention(z(1, 6, 8, 16), z(1, 4, 8, 16), z(1, 4, 8, 16))
    with pytest.raises(ValueError, match=r"kv heads Hkv"):
        ops.flash_attention(z(1, 4, 8, 16), z(1, 2, 8, 16), z(1, 1, 8, 16))
    with pytest.raises(ValueError, match=r"sequence dim S"):
        ops.flash_attention(z(1, 4, 8, 16), z(1, 2, 9, 16), z(1, 2, 9, 16))
    with pytest.raises(ValueError, match=r"head_dim D mismatch"):
        ops.flash_attention(z(1, 4, 8, 16), z(1, 2, 8, 32), z(1, 2, 8, 32))
    with pytest.raises(ValueError, match=r"share one dtype"):
        ops.flash_attention(z(1, 2, 8, 16, dtype=torch.float64),
                            z(1, 2, 8, 16), z(1, 2, 8, 16))
    with pytest.raises(ValueError, match=r"must be \(B, H, S, D\)"):
        ops.flash_attention(z(2, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16))
    with pytest.raises(ValueError, match=r"window=-1"):
        ops.flash_attention(z(1, 2, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16),
                            window=-1)


# --- Launch configuration of the GEMM (kernels/gemm.py: gemm_config) and
# the accounting helpers of chip_smoke.py, both pure Python.

from repro_torch.kernels import gemm as kgemm  # noqa: E402

#: The sweep's 27 shapes (400, 800, 1200)³ as (m, k, n), and the shapes of
#: the gemm tests on the card (tests/test_torch_gpu.py).
SWEEP_SHAPES = [(m, k, n) for m in (400, 800, 1200) for k in (400, 800, 1200)
                for n in (400, 800, 1200)]
CARD_TEST_SHAPES = [
    (64, 64, 64), (1, 128, 128), (130, 70, 200), (129, 257, 130),
    (1200, 400, 1200), (1100, 333, 1037), (1152, 40, 1152), (1024, 40, 1152),
    (640, 40, 1024), (640, 40, 960), (576, 600, 576), (512, 600, 512),
    (1025, 40, 1024), (1000, 40, 1000), (400, 1200, 400), (400, 255, 400),
    (400, 256, 400), (64, 4096, 64), (65, 1000, 33), (1, 700, 1),
    (1, 3000, 900), (900, 3000, 1), (700, 1, 700), (16, 17, 15),
    (300, 320, 290), (5, 0, 3), (400, 383, 400), (400, 384, 400),
    (256, 383, 768), (256, 600, 1200), (384, 800, 1024), (640, 1200, 800),
    (768, 1200, 1200)]


def _candidates(k):
    """Every (tile, split) launch gemm_config may make for contraction k:
    1 to MAX_SPLIT slices, none shallower than MIN_SLICE."""
    most = max(1, min(kgemm.MAX_SPLIT, k // kgemm.MIN_SLICE))
    return [kgemm.with_split(config, k, split)
            for config in range(len(kgemm.TILES))
            for split in range(1, most + 1)]


@pytest.mark.parametrize("m,k,n", SWEEP_SHAPES + CARD_TEST_SHAPES)
def test_gemm_config_covers_output_and_contraction_exactly_once(m, k, n):
    cfg = kgemm.gemm_config(m, n, k)
    assert kgemm.TILES[cfg.config] == (cfg.bm, cfg.bn)
    assert cfg.kchunk % kgemm.BK == 0 and cfg.split >= 1
    cover = np.zeros((m, n), dtype=np.int64)
    slices = set()
    for row0, col0, k0, k1 in kgemm.gemm_blocks(m, n, k, cfg):
        assert 0 <= row0 < max(m, 1) and 0 <= col0 < max(n, 1)
        cover[row0:row0 + cfg.bm, col0:col0 + cfg.bn] += 1
        slices.add((k0, k1))
    assert (cover == cfg.split).all()   # each element once per slice
    seen = np.zeros(k, dtype=np.int64)
    for k0, k1 in slices:
        assert k0 < k1 or k == 0       # no empty slice
        seen[k0:k1] += 1
    assert (seen == 1).all() and len(slices) == cfg.split
    assert sum(1 for _ in kgemm.gemm_blocks(m, n, k, cfg)) == cfg.blocks(m, n)


@pytest.mark.parametrize("m,k,n", SWEEP_SHAPES + CARD_TEST_SHAPES)
def test_gemm_config_fills_the_card_with_the_largest_tile_it_can(m, k, n):
    """The launch of least modeled time: the busiest SM's share of the
    grid in whole blocks at its tile's rate, plus a split's workspace
    pass; ties go to the larger tile, then to fewer slices. A split never
    passes MAX_SPLIT slices nor cuts one shallower than MIN_SLICE."""
    sms = kgemm.SMS
    cfg = kgemm.gemm_config(m, n, k, sms)

    def cost(c):
        waves = -(-c.blocks(m, n) // sms)
        return (waves * c.bm * c.bn * c.kchunk * 1e-6
                * kgemm.US_PER_MMAC[c.config]
                + (kgemm.US_SPLIT if c.split > 1 else 0.0))

    best = min(cost(c) for c in _candidates(k))
    assert cost(cfg) == best
    assert not any(cost(c) == best and c.config < cfg.config
                   for c in _candidates(k))
    assert cfg.split <= kgemm.MAX_SPLIT
    assert cfg.split == 1 or cfg.kchunk >= kgemm.MIN_SLICE


def test_gemm_config_on_the_sweep_shapes():
    """At 132 SMs the model picks, among the 12 launches timed at each of
    the sweep's shapes, one within 8 % of the fastest (PERF.md, section
    6): 1200x400x1200 on 128x128 tiles (100 blocks), 800³ and
    400x1200x400 on 128x64 split in four, 1200x1200x400 on 128x128 split
    in three, and 800x400x1200 on 64x64."""
    names = {(m, k, n): kgemm.gemm_config(m, n, k).name
             for m, k, n in SWEEP_SHAPES}
    assert names[(1200, 400, 1200)] == "128x128"
    assert names[(800, 800, 800)] == "128x64 split 4x208"
    assert names[(400, 1200, 400)] == "128x64 split 4x304"
    assert names[(1200, 1200, 400)] == "128x128 split 3x400"
    assert names[(800, 400, 1200)] == "64x64"
    assert names[(400, 400, 400)] == "128x64 split 4x112"
    assert {name.split()[0] for name in names.values()} == {
        "128x128", "128x64", "64x64"}


def _chip_smoke():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("s,causal,window", [
    (2048, True, 0), (2048, False, 0), (1000, True, 512), (1024, True, 512),
    (333, False, 100), (384, True, 64), (70, False, 20), (1, True, 0),
    (5, True, 9), (5, False, 9), (64, False, 64), (129, True, 1)])
def test_chip_smoke_attention_pairs_match_the_mask(s, causal, window):
    """attention_pairs counts exactly the pairs the plain version's mask
    leaves visible."""
    idx = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window > 0:
        mask &= idx[:, None] - idx[None, :] < window
    assert _chip_smoke().attention_pairs(s, causal, window) == int(mask.sum())


def test_chip_smoke_attention_pairs_and_bound():
    cs = _chip_smoke()
    assert cs.attention_pairs(2048, True, 0) == 2048 * 2049 // 2
    # Yi-9B's prefill layer: operations bound at the bf16 peak.
    flops = 4 * 128 * cs.attention_pairs(2048, True, 0) * 2 * 32
    ms, by = cs.bound(flops, 2 * (2 * 2 * 32 * 2048 * 128
                                  + 2 * 2 * 4 * 2048 * 128),
                      cs.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    # A float32 GEMM at 1200x400x1200 is operations-bound at 67 TFLOP/s;
    # a tiny one moving many bytes is bytes-bound.
    ms, by = cs.bound(2 * 1200 * 400 * 1200,
                      4 * (1200 * 400 * 2 + 1200 * 1200))
    assert by == "operations" and ms == pytest.approx(0.0171940298507)
    ms, by = cs.bound(10, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)


def _causal_rounding_p_first(q, k, v):
    """Causal attention rounding p = exp(s - row max) to bfloat16 before
    P·V and dividing by the float32 row sum after, as the tensor-core
    kernel rounds (the plain version rounds p after normalising)."""
    group = q.shape[1] // k.shape[1]
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    logits = (q.float() @ kq.mT) * q.shape[-1] ** -0.5
    i = torch.arange(q.shape[2])
    logits = logits.masked_fill(i[:, None] < i[None, :], float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return ((p.to(torch.bfloat16).float() @ vq)
            / p.sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
def test_chip_smoke_flash_check_rejects_a_dropped_key_tile(d):
    """At phase 6's input scale the bf16 check passes the kernel's
    rounding and rejects one fully visible 32-key tile dropped."""
    cs = _chip_smoke()
    rng = np.random.default_rng(d)
    q, k, v = (cs.attention_heads(torch, rng, 1, 512, n, d, torch.bfloat16,
                                  scale, device="cpu")
               for n, scale in ((4, cs.QK_SCALE), (2, cs.QK_SCALE), (2, 1.0)))
    want = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(cs.attention_hiding_keys(torch, q, k, v, 0, 0), want)
    assert cs.flash_close(_causal_rounding_p_first(q, k, v), want,
                          "bfloat16")[0]
    close, err = cs.flash_close(
        want, cs.attention_hiding_keys(torch, q, k, v, 256, 288), "bfloat16")
    assert not close and err > 0.25


# --- Schedule twins of SYMM and the chain (kernels/symm.py: symm_config,
# symm_segments; kernels/chain_gemm.py: chain_config, chain_blocks): the
# launchers' index maps, pure Python, and CPU replays that walk the
# kernels' blocks and segments. The replays read S only as the segment's
# copy mode does and keep each M1 piece local to its block; they are held
# at TOL (SYMM) and CHAIN_TOL (the chain, whose second contraction runs
# over values ~sqrt(k) larger) against the plain versions, the JAX
# reference's oracles and its Pallas kernels in interpret mode.

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chain_gemm import chain_gemm_pallas  # noqa: E402
from repro.kernels.symm import symm_pallas  # noqa: E402
from repro_torch.kernels import chain_gemm as kchain  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import symm as ksymm  # noqa: E402


def _sweep_shapes():
    """Every SYMM and chain shape the sweep of chip_smoke.py launches, as
    ab_bench.py finds them by walking the sweep's algorithms on meta
    tensors (chip_smoke's phase 4 counts 648 and 1160 launches of them)."""
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:   # ab_bench.py imports chip_smoke.py beside it
        sys.path.insert(0, root)
    import ab_bench
    return ab_bench.sweep_shapes()


_SWEEP = _sweep_shapes()
#: (m, n) of every SYMM the sweep launches (either side), and ragged ones:
#: m not a multiple of 16 makes the last band ragged.
SYMM_SWEEP_SHAPES = sorted({(m, n) for m, n, _ in _SWEEP["symm"]})
SYMM_RAGGED_SHAPES = [(1100, 333), (1037, 129), (200, 70), (77, 50),
                      (129, 64), (17, 3), (1, 5)]
#: (m, k, l, n) of every chain the sweep launches (fused gemm+gemm pairs
#: of aatb, abcd and abab).
CHAIN_SWEEP_SHAPES = list(_SWEEP["chain_gemm"])
CHAIN_RAGGED_SHAPES = [(1100, 333, 1037, 555), (130, 70, 150, 60),
                       (65, 33, 200, 17), (5, 3, 1, 2), (64, 64, 64, 64),
                       (129, 16, 129, 129)]


def _symm_launches(m, n):
    """The launch symm_config picks and every candidate it chooses from."""
    return [ksymm.symm_config(m, n)] + kgemm.candidates(m)


@pytest.mark.parametrize("m,n", SYMM_SWEEP_SHAPES + SYMM_RAGGED_SHAPES)
def test_symm_schedule_covers_output_and_contraction_exactly_once(m, n):
    """Every launch covers each output element once per slice, and the
    segments of each row tile's slices cover its contraction [0, m) once,
    in order, each starting on a slab boundary."""
    assert ksymm.symm_config(m, n) == kgemm.gemm_config(m, n, m)
    for cfg in _symm_launches(m, n):
        cover = np.zeros((m, n), dtype=np.int64)
        k_cover = {}
        for row0, col0, k0, k1 in kgemm.gemm_blocks(m, n, m, cfg):
            cover[row0:row0 + cfg.bm, col0:col0 + cfg.bn] += 1
            segs = ksymm.symm_segments(row0, cfg.bm, k0, k1)
            assert segs[0][1] == k0 and segs[-1][2] == k1
            assert all(e == s for (_, _, e), (_, s, _) in zip(segs, segs[1:]))
            assert [kind for kind, _, _ in segs] == sorted(
                (kind for kind, _, _ in segs),
                key=("below", "band", "above").index)
            for _, s, e in segs:
                assert s < e and s % kgemm.BK == 0
                if col0 == 0:
                    k_cover.setdefault(row0, np.zeros(m, dtype=np.int64))[s:e] += 1
        assert (cover == cfg.split).all()
        assert sorted(k_cover) == list(range(0, m, cfg.bm))
        assert all((kc == 1).all() for kc in k_cover.values())


@pytest.mark.parametrize("m,n", SYMM_SWEEP_SHAPES + SYMM_RAGGED_SHAPES)
def test_symm_band_is_the_only_segment_with_mixed_reads(m, n):
    """Below the band every (i, k) is strictly below the diagonal (S read
    as stored), above it strictly above (S read transposed); only the
    band, the rows' own columns, reads both sides."""
    for cfg in _symm_launches(m, n):
        for row0, _, k0, k1 in kgemm.gemm_blocks(m, n, m, cfg):
            rows = np.arange(row0, min(m, row0 + cfg.bm))[:, None]
            for kind, s, e in ksymm.symm_segments(row0, cfg.bm, k0, k1):
                ks = np.arange(s, e)[None, :]
                if kind == "below":
                    assert (rows > ks).all()
                elif kind == "above":
                    assert (rows < ks).all()
                else:
                    assert row0 <= s and e <= row0 + cfg.bm
                    if e - s > 1 and rows.size > 1:
                        assert (rows > ks).any() and (rows < ks).any()


def _symm_replay(s, b, cfg):
    """sym(S)·B as the kernel schedules it: each block of the launch
    accumulates its segments, reading S(i, k) below the band, S(k, i)
    above it and S(max, min) in it; slices are summed in slice order.
    Returns the product and the mask of S's elements read."""
    m, n = b.shape
    read = torch.zeros((m, m), dtype=torch.bool)
    slices = torch.zeros((cfg.split, m, n), dtype=torch.float32)
    idx = torch.arange(m)
    for row0, col0, k0, k1 in kgemm.gemm_blocks(m, n, m, cfg):
        r1, c1 = min(m, row0 + cfg.bm), min(n, col0 + cfg.bn)
        rows = idx[row0:r1, None]
        for kind, s0, e0 in ksymm.symm_segments(row0, cfg.bm, k0, k1):
            ks = idx[None, s0:e0]
            if kind == "below":
                i, k = rows, ks
            elif kind == "above":
                i, k = ks, rows
            else:
                i, k = torch.maximum(rows, ks), torch.minimum(rows, ks)
            i, k = torch.broadcast_tensors(i, k)
            read[i, k] = True
            slices[k0 // cfg.kchunk, row0:r1, col0:c1] += (
                s[i, k] @ b[s0:e0, col0:c1])
    out = slices[0]
    for p in range(1, cfg.split):
        out = out + slices[p]
    return out, read


@pytest.mark.parametrize("m,n,b_view", [(256, 128, False), (200, 70, False),
                                        (129, 33, True), (333, 50, False)])
def test_symm_replay_reads_only_the_lower_triangle_and_matches(m, n, b_view):
    """Every launch symm_config may make, replayed on inputs with garbage
    of 1e3 above S's diagonal: only the lower triangle is read, all of it,
    and the product matches the plain version, the reference's oracle
    and (at block-divisible sizes) its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(m + n)
    low = np.tril(_rand(rng, m, m))
    s_np = low + np.triu(_rand(rng, m, m) * 1e3, 1)
    b_np = _rand(rng, n, m).T if b_view else _rand(rng, m, n)
    s_t = torch.from_numpy(s_np)
    b_t = torch.from_numpy(np.ascontiguousarray(b_np.T)).mT if b_view \
        else torch.from_numpy(b_np)
    want = tref.symm(s_t, b_t).numpy()
    np.testing.assert_allclose(
        want, np.asarray(jref.symm(jnp.asarray(s_np), jnp.asarray(b_np))),
        **TOL)
    if m % 128 == 0 and n % 128 == 0:
        np.testing.assert_allclose(want, np.asarray(symm_pallas(
            jnp.asarray(s_np), jnp.asarray(b_np), interpret=True)), **TOL)
    lower = torch.tril(torch.ones((m, m), dtype=torch.bool))
    for cfg in _symm_launches(m, n):
        got, read = _symm_replay(s_t, b_t, cfg)
        assert torch.equal(read, lower), cfg
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,k,l,n", CHAIN_SWEEP_SHAPES + CHAIN_RAGGED_SHAPES)
def test_chain_schedule_builds_each_m1_element_once(m, k, l, n):
    """Every piece launch covers M1 = A·B exactly once in pieces of at
    most bm x bl on bl boundaries, so the fusion adds no flops; each
    output element receives one partial sum per l-chunk."""
    for cfg in kchain.CONFIGS:
        cover = np.zeros((m, l), dtype=np.int64)
        blocks = list(kchain.chain_blocks(m, l, cfg))
        for row0, l0, l1 in blocks:
            assert l0 % cfg.bl == 0 and 0 < l1 - l0 <= cfg.bl
            assert row0 % cfg.bm == 0 and row0 < m
            cover[row0:row0 + cfg.bm, l0:l1] += 1
        assert (cover == 1).all()
        assert len(blocks) == cfg.blocks(m, l)
        assert len({l0 for _, l0, _ in blocks}) == cfg.chunks(l)


@pytest.mark.parametrize("m,k,l,n", CHAIN_SWEEP_SHAPES + CHAIN_RAGGED_SHAPES)
def test_chain_config_is_the_least_modeled_cost(m, k, l, n):
    """The busiest SM's multiply-adds over both products at the tile's
    GEMM rate; ties to the larger piece."""
    sms = kgemm.SMS
    cfg = kchain.chain_config(m, k, l, n, sms)

    def cost(c):
        per_block = c.bm * c.bl * (k + -(-n // c.bl) * c.bl)
        busiest = -(-c.blocks(m, l) // sms) * per_block
        return busiest * 1e-6 * kgemm.US_PER_MMAC[c.config]

    best = min(cost(c) for c in kchain.CONFIGS)
    assert cost(cfg) == pytest.approx(best, rel=1e-12)
    assert not any(cost(c) < cost(cfg) or (cost(c) == cost(cfg)
                                           and c.config < cfg.config)
                   for c in kchain.CONFIGS)


def _chain_replay(a, b, c, cfg):
    """(A·B)·C as the kernel schedules it: each block builds its piece of
    M1 from A's row tile and B's l-chunk (and nothing else), multiplies it
    by C's l-chunk in output tiles of bl columns into its chunk's partial
    sums, which are summed in chunk order."""
    m, n, l = a.shape[0], c.shape[1], c.shape[0]
    parts = torch.zeros((cfg.chunks(l), m, n), dtype=torch.float32)
    for row0, l0, l1 in kchain.chain_blocks(m, l, cfg):
        r1 = min(m, row0 + cfg.bm)
        piece = a[row0:r1] @ b[:, l0:l1]
        for col0 in range(0, n, cfg.bl):
            c1 = min(n, col0 + cfg.bl)
            parts[l0 // cfg.bl, row0:r1, col0:c1] = piece @ c[l0:l1, col0:c1]
    out = parts[0]
    for p in range(1, parts.shape[0]):
        out = out + parts[p]
    return out


@pytest.mark.parametrize("m,k,l,n,c_view", [
    (256, 128, 256, 128, False), (130, 70, 150, 60, True),
    (65, 33, 200, 17, False), (5, 3, 1, 2, False), (128, 40, 333, 96, True)])
def test_chain_replay_matches_plain_and_reference(m, k, l, n, c_view):
    rng = np.random.default_rng(m * k + l * n)
    a_np, b_np = _rand(rng, m, k), _rand(rng, k, l)
    c_np = _rand(rng, n, l).T if c_view else _rand(rng, l, n)
    a_t, b_t = torch.from_numpy(a_np), torch.from_numpy(b_np)
    c_t = torch.from_numpy(np.ascontiguousarray(c_np.T)).mT if c_view \
        else torch.from_numpy(c_np)
    want = tref.chain_gemm(a_t, b_t, c_t).numpy()
    jargs = [jnp.asarray(x) for x in (a_np, b_np, c_np)]
    np.testing.assert_allclose(want, np.asarray(jref.chain_gemm(*jargs)),
                               **CHAIN_TOL)
    if all(d % 128 == 0 for d in (m, k, l, n)):
        np.testing.assert_allclose(
            want, np.asarray(chain_gemm_pallas(*jargs, interpret=True)),
            **CHAIN_TOL)
    for cfg in kchain.CONFIGS:
        np.testing.assert_allclose(_chain_replay(a_t, b_t, c_t, cfg).numpy(),
                                   want, **CHAIN_TOL)


def test_symm_and_chain_configs_on_the_main_path_shapes():
    """At 132 SMs: SYMM 1200x400 takes the GEMM's pick for 1200x1200x400
    (128x128 tiles, the contraction split in three: 120 blocks); the
    chain 1200·800·1200·400 takes 64x64 pieces (361 blocks, 19 l-chunks),
    within 5 % of the fastest piece on the card (PERF.md, section 6)."""
    assert ksymm.symm_config(1200, 400).name == "128x128 split 3x400"
    cfg = kchain.chain_config(1200, 800, 1200, 400)
    assert cfg.name == "64x64" and cfg.blocks(1200, 1200) == 361
    assert {kchain.chain_config(*s).name for s in CHAIN_SWEEP_SHAPES} == {
        "128x128", "128x64", "64x64"}


# --- Schedule twins of SYRK and the fused GEMM+SYRK (kernels/syrk.py:
# syrk_config, syrk_blocks, tile_of; kernels/gemm_syrk.py:
# gemm_syrk_config, gemm_syrk_blocks, executed_flops): the launchers'
# index maps, pure Python, and CPU replays that walk the kernels' blocks,
# clusters and pairs. The SYRK replay starts from an output of NaNs, as
# torch.empty may hand the kernel, so it also shows that every element is
# written. It is held at TOL against the plain version, the reference's
# oracle and syrk_pallas in interpret mode; the GEMM+SYRK replay, whose
# diagonal is ~l·k, at PERF.md section 2's scaled bound max|err| <= 1e-2 +
# 1e-5·max|plain| (as tests/test_torch_gpu.py and chip_smoke.py hold the
# kernel), against the plain version, the reference's gemm and syrk
# oracles and gemm_syrk_pallas in interpret mode.

from repro.kernels.chain_gemm import gemm_syrk_pallas  # noqa: E402
from repro.kernels.syrk import syrk_pallas  # noqa: E402
from repro_torch.kernels import gemm_syrk as kfused  # noqa: E402
from repro_torch.kernels import syrk as ksyrk  # noqa: E402

#: (m, k) of every SYRK and (m, k, l) of every fused GEMM+SYRK the sweep of
#: chip_smoke.py launches (648 and 108 launches), and ragged ones.
SYRK_SWEEP_SHAPES = list(_SWEEP["syrk"])
SYRK_RAGGED_SHAPES = [(1100, 333), (129, 257), (65, 17), (300, 1000),
                      (1, 5), (200, 0)]
GEMM_SYRK_SWEEP_SHAPES = list(_SWEEP["gemm_syrk"])
GEMM_SYRK_RAGGED_SHAPES = [(1100, 333, 1037), (130, 70, 90), (37, 50, 100),
                           (200, 17, 33), (65, 64, 15), (1, 5, 130)]
MAIN_GEMM_SYRK = (1200, 400, 800)


def _syrk_launches(m, k):
    """The launch syrk_config picks and every candidate it chooses from."""
    return [ksyrk.syrk_config(m, k)] + ksyrk.syrk_candidates(k)


def test_chip_smoke_sweep_launch_counts_are_the_sweeps_kernel_steps():
    """chip_smoke.SWEEP_LAUNCHES: every kernel step of the sweep's
    algorithms, each run 2 + REPS times on the card (one eager walk
    before the capture, one warm-up replay, REPS timed replays)."""
    cs = _chip_smoke()
    steps = {kind: sum(sum(c.values()) for c in shapes.values())
             for kind, shapes in _SWEEP.items()}
    assert cs.SWEEP_STEPS == steps
    assert cs.EXECUTIONS == 2 + cs.REPS
    assert cs.SWEEP_LAUNCHES == {kind: n * (2 + cs.REPS)
                                 for kind, n in steps.items()}


@pytest.mark.parametrize("mt", [1, 2, 3, 10, 19, 100, 377])
def test_syrk_tile_decode_is_tril_indices(mt):
    """The kernel's decode of its block index, float32 estimate included,
    walks np.tril_indices: every lower tile once, in row-major order."""
    ii, jj = np.tril_indices(mt)
    assert [ksyrk.tile_of(t) for t in range(ksyrk.tiles(mt, 1))] == \
        list(zip(ii.tolist(), jj.tolist()))


@pytest.mark.parametrize("m,k", SYRK_SWEEP_SHAPES + SYRK_RAGGED_SHAPES)
def test_syrk_schedule_covers_each_lower_tile_once_per_slice(m, k):
    """Every launch runs each lower-triangular tile once per slice, no
    tile above the diagonal, and each tile's slices cover [0, k) once."""
    for cfg in _syrk_launches(m, k):
        assert cfg.bm == cfg.bn and cfg.kchunk % kgemm.BK == 0
        blocks = list(ksyrk.syrk_blocks(m, k, cfg))
        assert len(blocks) == ksyrk.tiles(m, cfg.bm) * cfg.split
        tiles, slices = {}, {}
        for row0, col0, k0, k1 in blocks:
            assert col0 <= row0 < max(m, 1)
            assert row0 % cfg.bm == 0 and col0 % cfg.bm == 0
            tiles[row0, col0] = tiles.get((row0, col0), 0) + 1
            slices.setdefault((row0, col0), []).append((k0, k1))
        mt = -(-m // cfg.bm)
        assert sorted(tiles) == sorted((i * cfg.bm, j * cfg.bm)
                                       for i in range(mt)
                                       for j in range(i + 1))
        assert set(tiles.values()) == {cfg.split}
        for cuts in slices.values():
            seen = np.zeros(k, dtype=np.int64)
            for k0, k1 in cuts:
                assert k0 < k1 or k == 0
                seen[k0:k1] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("m,k", SYRK_SWEEP_SHAPES + SYRK_RAGGED_SHAPES)
def test_syrk_config_is_the_least_modeled_cost(m, k):
    """The GEMM's model over the T·split blocks of the triangular grid:
    the busiest SM's multiply-adds at the tile's rate plus a split's
    pass; ties to the larger tile, then to fewer slices."""
    sms = kgemm.SMS
    cfg = ksyrk.syrk_config(m, k, sms)

    def cost(c):
        mt = -(-m // c.bm)
        waves = -(-(mt * (mt + 1) // 2 * c.split) // sms)
        return (waves * c.bm * c.bn * c.kchunk * 1e-6
                * kgemm.US_PER_MMAC[c.config]
                + (kgemm.US_SPLIT if c.split > 1 else 0.0))

    best = min(cost(c) for c in ksyrk.syrk_candidates(k))
    assert cost(cfg) == pytest.approx(best, rel=1e-12)
    assert not any((cost(c), c.config, c.split) < (cost(cfg), cfg.config,
                                                   cfg.split)
                   for c in ksyrk.syrk_candidates(k))


def _syrk_replay(a, cfg):
    """tril(A·Aᵀ) as the kernel schedules it, into an output of NaNs: each
    block multiplies A's row panel by the transpose of another over its
    slice; one slice stores a diagonal tile with zeros above its diagonal
    and an off-diagonal tile with the zero tile at its mirror, several go
    to a workspace summed in slice order with zeros above the diagonal."""
    m, k = a.shape
    out = torch.full((m, m), float("nan"))
    slices = torch.full((cfg.split, m, m), float("nan"))
    for row0, col0, k0, k1 in ksyrk.syrk_blocks(m, k, cfg):
        r1, c1 = min(m, row0 + cfg.bm), min(m, col0 + cfg.bm)
        tile = a[row0:r1, k0:k1] @ a[col0:c1, k0:k1].mT
        if cfg.split > 1:
            slices[k0 // cfg.kchunk, row0:r1, col0:c1] = tile
            continue
        if row0 == col0:
            tile = torch.tril(tile)
        else:
            out[col0:c1, row0:r1] = 0.0
        out[row0:r1, col0:c1] = tile
    if cfg.split > 1:
        total = slices[0]
        for p in range(1, cfg.split):
            total = total + slices[p]
        lower = torch.tril(torch.ones((m, m), dtype=torch.bool))
        out = torch.where(lower, total, torch.zeros(()))
    return out


@pytest.mark.parametrize("m,k,a_view", [(256, 128, False), (200, 70, False),
                                        (129, 33, True), (333, 50, False),
                                        (256, 384, True)])
def test_syrk_replay_matches_plain_and_reference(m, k, a_view):
    """Every launch syrk_config may make, replayed: no element is left
    unwritten, the upper triangle is exactly zero, and the product
    matches the plain version, the reference's oracle and (at
    block-divisible sizes) its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(m + k)
    a_np = _rand(rng, k, m).T if a_view else _rand(rng, m, k)
    a_t = torch.from_numpy(np.ascontiguousarray(a_np.T)).mT if a_view \
        else torch.from_numpy(a_np)
    want = tref.syrk(a_t).numpy()
    np.testing.assert_allclose(want, np.asarray(jref.syrk(jnp.asarray(a_np))),
                               **TOL)
    if m % 128 == 0 and k % 128 == 0:
        np.testing.assert_allclose(want, np.asarray(syrk_pallas(
            jnp.asarray(a_np), interpret=True)), **TOL)
    for cfg in _syrk_launches(m, k):
        got = _syrk_replay(a_t, cfg).numpy()
        assert not np.isnan(got).any(), cfg
        assert (np.triu(got, 1) == 0).all(), cfg
        np.testing.assert_allclose(got, want, **TOL)


def test_syrk_config_on_the_main_path_shape():
    """At 132 SMs, 1200x800 takes 128x128 tiles with the contraction split
    in two: 55 tiles x 2 = 110 blocks, one wave (PERF.md, section 6)."""
    cfg = ksyrk.syrk_config(1200, 800)
    assert cfg.name == "128x128 split 2x400"
    assert ksyrk.tiles(1200, cfg.bm) * cfg.split == 110


@pytest.mark.parametrize("m,k,l", GEMM_SYRK_SWEEP_SHAPES
                         + GEMM_SYRK_RAGGED_SHAPES)
def test_gemm_syrk_schedule_builds_m1_once_and_covers_pairs_once(m, k, l):
    """Every launch the rule may make: the CTAs of each cluster build each
    64 x bl piece of their l-chunk exactly once (so each element of M1
    once, never in another cluster), multiply each lower tile pair of the
    chunk exactly once, and no CTA has more than ceil(pairs / C) + 1
    pairs."""
    mt = -(-m // kfused.BM)
    pairs = mt * (mt + 1) // 2
    assert kfused.gemm_syrk_config(m, k, l) in kfused.candidates(m)
    for cfg in kfused.candidates(m):
        built = np.zeros((mt, cfg.chunks(l)), dtype=np.int64)
        multiplied = {}
        ctas = list(kfused.gemm_syrk_blocks(m, k, l, cfg))
        assert len(ctas) == cfg.blocks(l)
        for chunk, rank, pieces, tile_pairs in ctas:
            assert 0 <= rank < cfg.cluster and len(pieces) <= cfg.slots(m)
            assert len(tile_pairs) <= -(-pairs // cfg.cluster) + 1
            for i in pieces:
                built[i, chunk] += 1
            for i, j in tile_pairs:
                assert 0 <= j <= i < mt
                key = (chunk, i, j)
                multiplied[key] = multiplied.get(key, 0) + 1
        assert (built == 1).all()
        assert len(multiplied) == pairs * cfg.chunks(l)
        assert set(multiplied.values()) == {1}


@pytest.mark.parametrize("m,k,l", GEMM_SYRK_SWEEP_SHAPES)
def test_gemm_syrk_executes_near_the_papers_flops(m, k, l):
    """The flops the chosen launch executes (pieces over k and pairs over
    their chunk, each in 16-deep slabs, padding included) are at most
    1.5x the paper's 2mkl + (m+1)ml at every sweep shape and 1.15x at the
    main path's 1200·400·800; the earlier design, which rebuilt the
    pieces of every row tile above its own, executed 4.86x there."""
    cfg = kfused.gemm_syrk_config(m, k, l)
    paper = 2 * m * k * l + (m + 1) * m * l
    executed = 0
    for chunk, _, pieces, tile_pairs in kfused.gemm_syrk_blocks(m, k, l, cfg):
        width = min(l, (chunk + 1) * cfg.bl) - chunk * cfg.bl
        executed += 2 * len(pieces) * 64 * cfg.bl * (-(-k // 16) * 16)
        executed += 2 * len(tile_pairs) * 64 * 64 * (-(-width // 16) * 16)
    assert kfused.executed_flops(m, k, l, cfg) == executed
    assert executed <= (1.15 if (m, k, l) == MAIN_GEMM_SYRK else 1.5) * paper


@pytest.mark.parametrize("m,k,l", GEMM_SYRK_SWEEP_SHAPES
                         + GEMM_SYRK_RAGGED_SHAPES)
def test_gemm_syrk_config_is_the_least_modeled_cost(m, k, l):
    """Waves of clusters (ACTIVE_CLUSTERS resident) times the busiest
    CTA's pieces and pairs at their fitted rates; ties to the wider
    chunk, then to the smaller cluster."""
    mt = -(-m // 64)

    def cost(c):
        ppc = -(-(mt * (mt + 1) // 2) // c.cluster)
        per_cta = (-(-mt // c.cluster) * 64 * c.bl * (-(-k // 16) * 16)
                   * 1e-6 * kfused.US_PER_MMAC_PIECE[
                       kfused.WIDTHS.index(c.bl)]
                   + ppc * 64 * 64 * c.bl * 1e-6 * kfused.US_PER_MMAC_PAIR
                   + ppc * kfused.US_PER_PAIR)
        waves = -(-c.chunks(l) // kfused.ACTIVE_CLUSTERS[c.cluster - 1])
        return waves * per_cta

    cfg = kfused.gemm_syrk_config(m, k, l)
    fit = [c for c in kfused.CONFIGS if c.smem_bytes(m) <= 232448]
    assert fit == kfused.candidates(m)
    assert cost(cfg) == pytest.approx(min(cost(c) for c in fit), rel=1e-12)
    assert not any((cost(c), -c.bl, c.cluster) < (cost(cfg), -cfg.bl,
                                                  cfg.cluster) for c in fit)


def test_gemm_syrk_config_on_the_main_path_and_at_the_size_bound():
    """1200·400·800 takes chunks of 64 over clusters of 8: 13 clusters,
    104 CTAs, one wave. max_m() is the largest m whose panel the
    narrowest launch holds (16-wide chunks over 8 CTAs); one row more and
    the wrapper falls back to gemm and syrk."""
    cfg = kfused.gemm_syrk_config(*MAIN_GEMM_SYRK)
    assert cfg.name == "bl64 c8" and cfg.blocks(800) == 104
    top = kfused.max_m()
    assert [c.name for c in kfused.candidates(top)] == ["bl16 c8"]
    assert kfused.candidates(top + 1) == []
    assert kfused.gemm_syrk_config(top + 1, 24, 40) is None


def _gemm_syrk_replay(a, b, cfg):
    """tril((A·B)(A·B)ᵀ) as the kernel schedules it: per l-chunk, every
    CTA of the cluster builds its pieces from A's row tile and B's chunk
    (and nothing else) into the cluster's store; after the cluster
    barrier each CTA multiplies its pairs from that store only, masks the
    diagonal tiles' upper halves and adds into a zeroed output."""
    m, k = a.shape
    l = b.shape[1]
    out = torch.zeros((m, m))
    by_chunk = {}
    for cta in kfused.gemm_syrk_blocks(m, k, l, cfg):
        by_chunk.setdefault(cta[0], []).append(cta)
    for chunk, ctas in by_chunk.items():
        l0, l1 = chunk * cfg.bl, min(l, (chunk + 1) * cfg.bl)
        store = {}
        for _, _, pieces, _ in ctas:
            for i in pieces:
                assert i not in store
                store[i] = a[i * 64:(i + 1) * 64] @ b[:, l0:l1]
        for _, _, _, tile_pairs in ctas:
            for i, j in tile_pairs:
                tile = store[i] @ store[j].mT
                if i == j:
                    tile = torch.tril(tile)
                out[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64] += tile
    return out


@pytest.mark.parametrize("m,k,l,a_view", [
    (256, 128, 128, False), (130, 70, 90, False), (37, 50, 100, True),
    (200, 17, 33, False), (128, 256, 384, True)])
def test_gemm_syrk_replay_matches_plain_and_reference(m, k, l, a_view):
    """Every launch the rule may make, replayed: M1 stays in its
    cluster's store, the upper triangle stays exactly zero, and the
    result matches the plain version, the reference's gemm and syrk
    oracles and (at block-divisible sizes) gemm_syrk_pallas in interpret
    mode."""
    rng = np.random.default_rng(m * k + l)
    a_np = _rand(rng, k, m).T if a_view else _rand(rng, m, k)
    b_np = _rand(rng, k, l)
    a_t = torch.from_numpy(np.ascontiguousarray(a_np.T)).mT if a_view \
        else torch.from_numpy(a_np)
    b_t = torch.from_numpy(b_np)
    want = tref.gemm_syrk(a_t, b_t).numpy()
    bound = 1e-2 + 1e-5 * np.abs(want).max()
    jwant = np.asarray(jref.syrk(jref.gemm(jnp.asarray(a_np),
                                           jnp.asarray(b_np))))
    assert np.abs(jwant - want).max() <= bound
    if m % 128 == 0 and k % 128 == 0 and l % 128 == 0:
        jpallas = np.asarray(gemm_syrk_pallas(
            jnp.asarray(a_np), jnp.asarray(b_np), interpret=True))
        assert np.abs(jpallas - want).max() <= bound
    for cfg in kfused.candidates(m):
        got = _gemm_syrk_replay(a_t, b_t, cfg).numpy()
        assert (np.triu(got, 1) == 0).all(), cfg
        assert np.abs(got - want).max() <= bound, cfg
