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
                           "flash_attention"}


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
