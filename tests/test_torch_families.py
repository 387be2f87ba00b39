"""The port's MoE, SSM and hybrid families against the JAX package's, on
the CPU.

Same seeded numpy inputs and the same weights go through both packages
at smoke size: the reference's parameters are carried into the port by
``repro_torch.models.convert`` (whole models) or loaded leaf by leaf
(single layers). Float32 compares at rtol = atol = 1e-4, as in
tests/test_kernels.py, unless a test's docstring states otherwise. Both
packages store KV and SSM caches in bfloat16; the float32 values the two
compute differ by ~1e-7 of the O(1) terms summed, so a value next to a
rounding boundary may land one bfloat16 ulp apart: caches compare at
``CACHE_TOL`` (rtol = 2**-7, one ulp, atol = 1e-5), as in
tests/test_torch_models.py. The OLMoE prefill at S = 256 takes the flash
route: the reference's Pallas kernel in interpret mode, the port's plain
version (CPU tensors).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.perfmodel import AnalyticalTPUProfile as JTPUProfile
from repro.models import api as japi
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.serve.decode import generate as jgenerate
from repro_torch import configs
from repro_torch.core.perfmodel import (AnalyticalHopperProfile,
                                        AnalyticalTPUProfile)
from repro_torch.models import (api, attention, convert, hybrid, moe, ssm,
                                transformer)
from repro_torch.serve import decode

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-5)
#: The families' smoke models whose prefill, decode and training forward
#: are held against the reference (arctic_480b: the dense residual).
SERVED = ("olmoe_1b_7b", "arctic_480b", "mamba2_370m")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.tensor(_np(value))
    return out


def _load(module, params):
    """The reference's parameter tree of one layer into ``module``."""
    module.load_state_dict(_flat(params), strict=True)
    return module


@pytest.fixture(scope="module")
def smoke_models():
    """arch → (reference cfg, reference params, port cfg, port model)."""
    out = {}
    for arch in SERVED + ("zamba2_1p2b",):
        jcfg = jget_smoke(arch)
        params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke(arch)
        model = convert.from_reference_params(
            jax.tree.map(np.asarray, params), cfg, device="cpu")
        out[arch] = (jcfg, params, cfg, model)
    return out


# ------------------------------------------------------------------- MoE ---

MOE = moe.MoEConfig(d_model=32, d_ff=48, n_experts=4, top_k=2)


def _moe_pair(cfg, seed=0):
    params, _ = jmoe.init(jax.random.PRNGKey(seed), cfg)
    mod = moe.MoE(cfg, generator=None, device="cpu", dtype=torch.float32)
    return params, _load(mod, params)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("capacity_factor,group_size", [
    (0.5, 4096), (0.5, 8), (1.25, 16), (4.0, 4096)])
def test_moe_apply_matches_reference(dispatch, capacity_factor, group_size):
    """A capacity factor of 0.5 drops about half the assignments (into
    the gather path's overflow slot); group_size 8 and 16 split the 32
    tokens into 4 and 2 dispatch groups."""
    cfg = MOE._replace(dispatch=dispatch, capacity_factor=capacity_factor,
                       group_size=group_size)
    assert moe.MoEConfig(32, 48, 4, 2) == jmoe.MoEConfig(32, 48, 4, 2)
    params, mod = _moe_pair(cfg)
    x = _rand(np.random.default_rng(1), 2, 16, 32)
    got, aux = moe.apply(mod, cfg, torch.from_numpy(x))
    want, jaux = jmoe.apply(params, cfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_capacity_drops_and_dispatches_agree():
    """The port's two dispatches agree with each other in one group, drops
    included; with a tiny capacity some token keeps no expert at all."""
    cfg = MOE._replace(capacity_factor=0.25)
    assert moe.capacity(cfg, 32) == jmoe.capacity(cfg, 32) == 4
    assert moe.capacity(cfg, 1) == 1
    _, mod = _moe_pair(cfg, seed=3)
    x = torch.from_numpy(_rand(np.random.default_rng(2), 1, 32, 32))
    gather, aux_g = moe.apply(mod, cfg, x)
    einsum, aux_e = moe.apply(mod, cfg._replace(dispatch="einsum"), x)
    np.testing.assert_allclose(gather.numpy(), einsum.numpy(), **TOL)
    assert float(aux_g) == float(aux_e)
    assert bool((gather.abs().sum(-1) == 0).any())


# ------------------------------------------------------------------- SSM ---

@pytest.mark.parametrize("s,n,p,q,heads,disc", [
    (64, 128, 64, 64, 1, "flops"), (8192, 128, 64, 128, 1, "flops"),
    (65536, 128, 64, 128, 1, "perfmodel"), (64, 128, 64, 64, 1, "perfmodel"),
    (2048, 128, 64, 128, 32, "perfmodel"), (2048, 128, 64, 128, 32, "flops"),
    (512, 16, 32, 32, 4, "perfmodel"), (4096, 128, 64, 128, 32,
                                        "perfmodel")])
def test_select_ssd_mode_matches_reference(s, n, p, q, heads, disc):
    """Under the port's copy of the TPU profile, the reference's picks at
    the shapes of tests/test_models.py and at mamba2's; the Hopper
    profile never picks the quadratic form at the extremes."""
    assert [c.dims for c in ssm.ssd_algorithm_calls("chunked", s, n, p, q,
                                                    heads)] == \
        [c.dims for c in jssm.ssd_algorithm_calls("chunked", s, n, p, q,
                                                  heads)]
    got = ssm.select_ssd_mode(s, n, p, q, heads=heads, discriminant=disc,
                              profile=AnalyticalTPUProfile())
    want = jssm.select_ssd_mode(s, n, p, q, heads=heads, discriminant=disc,
                                profile=JTPUProfile())
    assert got == want == jssm.select_ssd_mode(s, n, p, q, heads=heads,
                                               discriminant=disc)
    assert ssm.select_ssd_mode(65536, 128, 64, 128, profile=
                               AnalyticalHopperProfile(sms=132)) == "chunked"


def _ssd_inputs(seed, b=2, s=64, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = _rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(_rand(rng, b, s, h))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return x, dt, a_log, _rand(rng, b, s, g, n), _rand(rng, b, s, g, n)


def test_ssd_quadratic_matches_reference():
    args = _ssd_inputs(0)
    got = ssm.ssd_quadratic(*map(torch.from_numpy, args))
    want = jssm.ssd_quadratic(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_reference(with_h0, chunk):
    """The serial loop over chunks computes the reference's associative
    scan, ``h0`` folded in first; without ``h0`` it also equals the
    quadratic form (1e-3, the two algorithms' float32 sums differ more
    than one algorithm's in two packages, as tests/test_models.py)."""
    args = _ssd_inputs(1)
    rng = np.random.default_rng(2)
    h0 = _rand(rng, 2, 4, 16, 8) if with_h0 else None
    targs = list(map(torch.from_numpy, args))
    y, st = ssm.ssd_chunked(*targs, chunk, h0=None if h0 is None else
                            torch.from_numpy(h0), return_state=True)
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                               h0=None if h0 is None else jnp.asarray(h0),
                               return_state=True)
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), _np(jst), **TOL)
    plain = ssm.ssd_chunked(*targs, chunk,
                            h0=None if h0 is None else torch.from_numpy(h0))
    assert torch.equal(plain, y)
    if h0 is None:
        np.testing.assert_allclose(y.numpy(),
                                   ssm.ssd_quadratic(*targs).numpy(),
                                   rtol=1e-3, atol=1e-3)


def _chunk_inputs(seed, g, chunk, s=48):
    """``_ssd_inputs`` (P = 16) in float64 and the chunk layout of
    ``ssd_chunked``'s stages: x, Δt, B, C (B, nc, Q, ...) and A."""
    x, dt, a_log, bm, cm = (torch.from_numpy(t).double() for t in
                            _ssd_inputs(seed, s=s, p=16, g=g))
    nc = s // chunk
    return (x.reshape(2, nc, chunk, *x.shape[2:]),
            dt.reshape(2, nc, chunk, dt.shape[2]),
            bm.reshape(2, nc, chunk, *bm.shape[2:]),
            cm.reshape(2, nc, chunk, *cm.shape[2:]), -torch.exp(a_log))


#: (G, Q): one and two groups, Q a multiple of 16 and a ragged one.
SSD_CHUNK_CASES = [(1, 16), (2, 16), (1, 24), (2, 24)]


def _decay(cum):
    """(B, nc, H, Q, Q): exp(cum_i − cum_j) where j <= i, else 0."""
    c = cum.transpose(2, 3)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.ones(diff.shape[-2:], dtype=torch.bool).tril()
    return torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))


def _heads(t, h):
    """(B, nc, Q, G, N) → (B, nc, Q, H, N), each group's heads."""
    return t.repeat_interleave(h // t.shape[3], dim=3)


class _KernelFormulas(torch.autograd.Function):
    """What ``kernels/ssd_chunk.cu`` computes, in plain torch: the forward
    (y_intra = K·x, s_c = Bᵀ·(w ⊙ x)) and the backward in the kernels'
    own decomposition. With U = (C·Bᵀ ⊙ L)ᵀ·dy and T = B·ds a head:
    dx = Δt·U + w·T, dΔt = x·U, dw = x·T and dcum = dy·y − Δt·(x·U)
    rowwise; d(C·Bᵀ) is dK ⊙ L ⊙ Δt_j summed over a group's heads,
    dK = dy·xᵀ, whence dC and dB, and dB adds Σ_h w_h ⊙ (x_h·ds_hᵀ)."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, cum, w):
        h = x.shape[3]
        scores = torch.einsum("bcign,bcjgn->bcgij", cmat, bmat)
        k = (scores.repeat_interleave(h // bmat.shape[3], dim=2)
             * _decay(cum) * dt.transpose(2, 3)[..., None, :])
        y = torch.einsum("bchij,bcjhp->bcihp", k, x)
        s = torch.einsum("bcjhn,bcjhp->bchnp", _heads(bmat, h) * w[..., None],
                         x)
        ctx.save_for_backward(x, bmat, cmat, dt, cum, w, y)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, bmat, cmat, dt, cum, w, y = ctx.saved_tensors
        b, nc, q, h, _ = x.shape
        g, n = bmat.shape[3:]
        decay = _decay(cum)
        scores = torch.einsum("bcign,bcjgn->bcgij", cmat, bmat)
        sl = scores.repeat_interleave(h // g, dim=2) * decay
        u = torch.einsum("bchij,bcihp->bcjhp", sl, dy)
        t = torch.einsum("bcjhn,bchnp->bcjhp", _heads(bmat, h), ds)
        dx = dt[..., None] * u + w[..., None] * t
        ddt = (x * u).sum(-1)
        dw = (x * t).sum(-1)
        dcum = (dy * y).sum(-1) - dt * ddt
        dk = torch.einsum("bcihp,bcjhp->bchij", dy, x)
        dsg = (dk * decay * dt.transpose(2, 3)[..., None, :]).reshape(
            b, nc, g, h // g, q, q).sum(3)
        dc = torch.einsum("bcgij,bcjgn->bcign", dsg, bmat)
        states = torch.einsum("bcjhp,bchnp->bcjhn", x * w[..., None], ds)
        db = (torch.einsum("bcgij,bcign->bcjgn", dsg, cmat)
              + states.reshape(b, nc, q, g, h // g, n).sum(4))
        return dx, db, dc, ddt, dcum, dw


@pytest.mark.parametrize("g,chunk", SSD_CHUNK_CASES)
def test_ssd_chunk_plain_forward_matches_intra_chunks(g, chunk, monkeypatch):
    """``_intra_kernel`` (cum, w and the chunk decays around the kernel)
    with the kernel's formulas in its place gives ``_intra_chunks``' four
    outputs."""
    from repro_torch.kernels import ssd_chunk
    monkeypatch.setattr(ssd_chunk, "intra", _KernelFormulas.apply)
    args = _chunk_inputs(5, g, chunk)
    for got, want in zip(ssm._intra_kernel(*args),
                         ssm._intra_chunks(*args)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("g,chunk", SSD_CHUNK_CASES)
def test_ssd_chunk_plain_backward_matches_autograd(g, chunk, monkeypatch):
    """The backward kernels' formulas give the gradients of x, Δt, B and
    C that autograd takes through ``_intra_chunks``, and ``gradcheck``
    holds them against finite differences."""
    from repro_torch.kernels import ssd_chunk
    monkeypatch.setattr(ssd_chunk, "intra", _KernelFormulas.apply)
    args = _chunk_inputs(6, g, chunk)
    gen = torch.Generator().manual_seed(7)
    cot = [torch.randn(o.shape, generator=gen, dtype=torch.float64)
           for o in ssm._intra_chunks(*args)]
    grads = []
    for stage in (ssm._intra_kernel, ssm._intra_chunks):
        leaves = [t.clone().requires_grad_(True) for t in args[:4]]
        grads.append(torch.autograd.grad(stage(*leaves, args[4]), leaves,
                                         cot))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    x, dt, bm, cm, a = (t[:1, :1] if t.dim() > 1 else t for t in args)
    cum = torch.cumsum(dt * a, dim=2)
    w = torch.exp(cum[:, :, -1:] - cum) * dt
    assert torch.autograd.gradcheck(
        _KernelFormulas.apply, [t.clone().requires_grad_(True) for t in
                                (x, bm, cm, dt, cum, w)], fast_mode=True)


@pytest.mark.parametrize("field,size,named", [
    ("n", 24, "N=24"), ("p", 272, "P=272"), ("g", 3, "G=3"),
    ("dt_q", 7, "dt must be (B, nc, Q, H)"), ("x_dims", 4, "x must have 5"),
    ("device", None, "runs on CUDA tensors only")])
def test_ssd_chunk_refuses_what_the_kernel_cannot_take(field, size, named):
    """The wrapper's ValueError names the dim it refuses: N or P not a
    multiple of 16 or over 256, heads not a multiple of the groups, a
    mismatched operand; and it names the device of CPU tensors, which
    the kernel does not take."""
    from repro_torch.kernels import ssd_chunk
    dims = dict(n=16, p=16, g=2, dt_q=8, x_dims=5)
    if field in dims:
        dims[field] = size
    x = torch.zeros((1, 2, 8, 4, dims["p"])[:dims["x_dims"]])
    bm = torch.zeros(1, 2, 8, dims["g"], dims["n"])
    dt = torch.zeros(1, 2, dims["dt_q"], 4)
    cum = w = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match=re.escape(named)):
        ssd_chunk.intra(x, bm, bm, dt, cum, w)


def test_ssd_chunked_state_handoff_matches_the_whole_sequence():
    """Two halves with the first half's state handed over equal the whole
    sequence (the reference's test, at its 1e-3)."""
    x, dt, a_log, bm, cm = map(torch.from_numpy, _ssd_inputs(3))
    y, st = ssm.ssd_chunked(x, dt, a_log, bm, cm, 16, return_state=True)
    y1, st1 = ssm.ssd_chunked(x[:, :32], dt[:, :32], a_log, bm[:, :32],
                              cm[:, :32], 16, return_state=True)
    y2, st2 = ssm.ssd_chunked(x[:, 32:], dt[:, 32:], a_log, bm[:, 32:],
                              cm[:, 32:], 16, h0=st1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st2.numpy(), st.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_causal_conv_and_split_match_reference():
    rng = np.random.default_rng(4)
    seq, w, b = _rand(rng, 2, 9, 6), _rand(rng, 4, 6), _rand(rng, 6)
    prev = _rand(rng, 2, 3, 6)
    for pv in (None, prev):
        got = ssm._causal_conv(*map(torch.from_numpy, (seq, w, b)),
                               prev=None if pv is None else
                               torch.from_numpy(pv))
        want = jssm._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                                 jnp.asarray(b),
                                 prev=None if pv is None else jnp.asarray(pv))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    cfg = configs.get_smoke("mamba2_370m").ssm
    z = _rand(rng, 1, 2, 2 * cfg.d_inner + 2 * cfg.d_state + cfg.n_heads)
    for a, b_ in zip(ssm._split_proj(cfg, torch.from_numpy(z)),
                     jssm._split_proj(cfg, jnp.asarray(z))):
        np.testing.assert_array_equal(a.numpy(), _np(b_))


SSM = ssm.SSMConfig(d_model=32, d_inner=64, n_heads=2, head_dim=32,
                    n_groups=1, d_state=8, conv_kernel=4, chunk=16)


def _mixer_pair(cfg, seed=0):
    params, _ = jssm.init(jax.random.PRNGKey(seed), cfg)
    mod = ssm.Mamba2Mixer(cfg, generator=None, device="meta",
                          dtype=torch.float32).to_empty(device="cpu")
    return params, _load(mod, params)


@pytest.mark.parametrize("mode", ["auto", "quadratic", "chunked"])
def test_mamba2_mixer_apply_train_matches_reference(mode):
    cfg = SSM._replace(ssd_mode=mode)
    params, mod = _mixer_pair(cfg)
    u = _rand(np.random.default_rng(5), 2, 32, 32)
    got = ssm.apply_train(mod, cfg, torch.from_numpy(u))
    want = jssm.apply_train(params, cfg, jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_and_decode_states_match_reference(dtype):
    """Prefill then four decode steps: outputs, conv tails and states
    against the reference's from the same cache dtype (float32 caches at
    TOL, bfloat16 at CACHE_TOL); decode's outputs track the sequential
    prefill of the same tokens (5e-3, the reference's own test)."""
    params, mod = _mixer_pair(SSM, seed=1)
    u = _rand(np.random.default_rng(6), 2, 36, 32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else CACHE_TOL
    jc = jssm.init_cache(SSM, 2, dtype=jdt)
    cache = ssm.init_cache(SSM, 2, dtype=tdt)
    want, jc = jssm.apply_prefill(params, SSM, jnp.asarray(u[:, :32]), jc)
    got, cache = ssm.apply_prefill(mod, SSM, torch.from_numpy(u[:, :32]),
                                   cache)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert int(cache.length) == int(jc.length) == 32
    for i in range(32, 36):
        np.testing.assert_allclose(cache.conv.float().numpy(),
                                   _np(jc.conv), **tol)
        np.testing.assert_allclose(cache.state.float().numpy(),
                                   _np(jc.state), **tol)
        # Decode from the reference's cache, so the steps compare alone.
        cache = cache._replace(conv=torch.tensor(_np(jc.conv)).to(tdt),
                               state=torch.tensor(_np(jc.state)).to(tdt))
        want, jc = jssm.apply_decode(params, SSM, jnp.asarray(u[:, i:i + 1]),
                                     jc)
        got, cache = ssm.apply_decode(mod, SSM, torch.from_numpy(
            u[:, i:i + 1]), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # The port's layer leaves the length to the model's step, which
    # advances the one its layers share (test_decode_from_the_same_cache_
    # matches_reference checks it there).
    assert int(jc.length) == 36 and int(cache.length) == 32
    full, _ = ssm.apply_prefill(mod, SSM, torch.from_numpy(u[:, :32]),
                                ssm.init_cache(SSM, 2, dtype=torch.float32))
    steps = ssm.init_cache(SSM, 2, dtype=torch.float32)
    outs = []
    for i in range(32):
        o, steps = ssm.apply_decode(mod, SSM, torch.from_numpy(u[:, i:i + 1]),
                                    steps)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_ssm_masked_exponent_keeps_long_decays_finite():
    """A strong decay over a long sequence overflows exp of the masked
    (upper) entries; masking the exponent keeps every output finite."""
    x, dt, a_log, bm, cm = map(torch.from_numpy, _ssd_inputs(7, s=128))
    dt = dt * 50.0
    assert bool(torch.isfinite(ssm.ssd_quadratic(x, dt, a_log, bm,
                                                 cm)).all())
    assert bool(torch.isfinite(ssm.ssd_chunked(x, dt, a_log, bm, cm,
                                               64)).all())


# ----------------------------------------------------------------- models ---

def _port_caches(cfg, jc):
    """The reference's caches as the port's (bfloat16 values unchanged)."""
    def t(a):
        return torch.tensor(_np(a)).to(torch.bfloat16)
    if cfg.family == "ssm":
        return transformer.LayerCaches(kv=None, ssm=ssm.SSMCache(
            t(jc.ssm.conv), t(jc.ssm.state),
            torch.tensor(int(jc.ssm.length[0]))))
    return transformer.LayerCaches(kv=attention.KVCache(
        t(jc.kv.k), t(jc.kv.v), torch.tensor(int(jc.kv.length[0]))))


def _prefill_len(cfg):
    """S = 256 takes the flash route in the attention families; the SSM
    prefill needs S a multiple of its chunk."""
    return 64 if cfg.family == "ssm" else 256


@pytest.mark.parametrize("arch", SERVED + ("zamba2_1p2b",))
def test_forward_train_logits_and_aux_match_reference(smoke_models, arch):
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 64, 10)
    want, jaux = japi.forward_train(params, jcfg, {"tokens": toks})
    got, aux = api.forward_train(model, cfg, {"tokens": toks})
    assert got.shape == (2, 64, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_logits_and_caches_match_reference(smoke_models,
                                                   monkeypatch, arch):
    jcfg, params, cfg, model = smoke_models[arch]
    s = _prefill_len(cfg)
    toks = _tokens(cfg, 2, s, 7)
    calls = []
    real = attention.kops.flash_attention
    monkeypatch.setattr(attention.kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, jc = japi.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                            japi.init_caches(params, jcfg, 2, s + 4))
    got, caches = api.prefill(model, cfg, {"tokens": toks},
                              api.init_caches(model, cfg, 2, s + 4))
    assert len(calls) == (0 if cfg.family == "ssm" else cfg.n_layers)
    assert got.shape == (2, s, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    if cfg.family == "ssm":
        assert caches.kv is None and int(caches.ssm.length) == s
        assert caches.ssm.state.dtype == torch.bfloat16
        np.testing.assert_allclose(caches.ssm.conv.float().numpy(),
                                   _np(jc.ssm.conv), **CACHE_TOL)
        np.testing.assert_allclose(caches.ssm.state.float().numpy(),
                                   _np(jc.ssm.state), **CACHE_TOL)
    else:
        assert caches.ssm is None and int(caches.kv.length) == s
        np.testing.assert_allclose(caches.kv.k.float().numpy(),
                                   _np(jc.kv.k), **CACHE_TOL)
        np.testing.assert_allclose(caches.kv.v.float().numpy(),
                                   _np(jc.kv.v), **CACHE_TOL)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_from_the_same_cache_matches_reference(smoke_models, arch):
    """Two requests: a MoE decode step has capacity 1 per expert, so
    tokens routed to one expert drop, as in the reference."""
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 32, 8)
    _, jc = japi.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                         japi.init_caches(params, jcfg, 2, 40))
    caches = _port_caches(cfg, jc)
    for step in range(3):
        nt = _tokens(cfg, 2, 1, 9 + step)
        want, jc = japi.decode_step(params, jcfg, jnp.asarray(nt), jc)
        got, caches = api.decode_step(model, cfg, nt, caches)
        assert got.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        if cfg.family == "ssm":
            assert int(caches.ssm.length) == int(jc.ssm.length[0]) \
                == 33 + step
            np.testing.assert_allclose(caches.ssm.state.float().numpy(),
                                       _np(jc.ssm.state), **CACHE_TOL)
            caches = _port_caches(cfg, jc)
        else:
            assert int(caches.kv.length) == int(jc.kv.length[0]) \
                == 33 + step
            np.testing.assert_allclose(caches.kv.k.float().numpy(),
                                       _np(jc.kv.k), **CACHE_TOL)


@pytest.mark.parametrize("arch,n", [("mamba2_370m", 0), ("zamba2_1p2b", 0),
                                    ("olmoe_1b_7b", 2)])
def test_decode_consult_is_bound_to_attention(smoke_models, monkeypatch,
                                              arch, n):
    """SSM and hybrid caches never ask the plan cache; the MoE family's
    KV cache asks once when it is set up (here twice: our init_caches and
    generate's)."""
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    consults = []
    monkeypatch.setattr(attention, "planned_pv_right_first",
                        lambda *a, **k: consults.append(a) or False)
    _, _, cfg, model = smoke_models[arch]
    caches = api.init_caches(model, cfg, 1, 40)
    if cfg.family == "ssm":
        assert transformer.plan_decode(cfg, caches) is caches
    decode.generate(model, cfg, [[3, 4]], max_new=2)
    assert len(consults) == n


@pytest.mark.parametrize("arch", SERVED + ("zamba2_1p2b",))
def test_generate_is_token_identical_to_reference(smoke_models, monkeypatch,
                                                  arch):
    """zamba2's prompt (40 tokens) runs past its 32-slot shared window:
    the ring buffer wraps and the ``age < window`` mask bites."""
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    jcfg, params, cfg, model = smoke_models[arch]
    prompt = _tokens(cfg, 2, 40, 11)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt),
                                max_new=6, max_s=48))
    got = decode.generate(model, cfg, prompt, max_new=6, max_s=48)
    assert got.shape == (2, 46) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- hybrid ---

def test_hybrid_decode_matches_reference_past_the_window(smoke_models):
    """40 steps from empty caches through a 32-slot ring buffer (it
    wraps at step 32), each step's logits and caches against the
    reference's from the same caches.

    The shared block rounds q, the probabilities and the attention output
    to the cache's bfloat16 before the next product, as the reference's
    does, so a float32 difference of ~1e-7 can flip one of those roundings
    by a bfloat16 ulp (2**-8 relative), which reaches the O(0.3) logits as
    ~2e-4: logits compare at rtol = atol = 1e-3, and all but 2 of the 40
    steps at TOL. The caches a flipped step writes downstream of the flip
    compare at atol 1e-3 (a small value moved by two ulps), the others at
    CACHE_TOL."""
    jcfg, params, cfg, model = smoke_models["zamba2_1p2b"]
    assert hybrid.n_shared_applications(cfg) == \
        jhybrid.n_shared_applications(jcfg) == 2
    jc = japi.init_caches(params, jcfg, 2, 48)
    caches = api.init_caches(model, cfg, 2, 48)
    assert caches.shared_kv.k.shape == tuple(jc.shared_kv.k.shape) == \
        (2, 2, 32, cfg.n_kv_heads, cfg.head_dim)
    toks = _tokens(cfg, 2, 40, 12)

    def t(a):
        return torch.tensor(_np(a)).to(torch.bfloat16)
    flipped = 0
    for i in range(40):
        want, jc = japi.decode_step(params, jcfg, jnp.asarray(
            toks[:, i:i + 1]), jc)
        got, caches = api.decode_step(model, cfg, toks[:, i:i + 1], caches)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-3,
                                   atol=1e-3)
        flip = not np.allclose(got.numpy(), _np(want), **TOL)
        flipped += flip
        tol = dict(CACHE_TOL, atol=1e-3) if flip else CACHE_TOL
        for mine, theirs in ((caches.shared_kv.k, jc.shared_kv.k),
                             (caches.shared_kv.v, jc.shared_kv.v),
                             (caches.ssm.conv, jc.ssm.conv),
                             (caches.ssm.state, jc.ssm.state)):
            np.testing.assert_allclose(mine.float().numpy(), _np(theirs),
                                       **tol)
        assert int(caches.shared_kv.length) == \
            int(jc.shared_kv.length[0]) == int(caches.ssm.length) == i + 1
        # The next step starts from the reference's caches.
        caches = hybrid.HybridCaches(
            ssm=ssm.SSMCache(t(jc.ssm.conv), t(jc.ssm.state),
                             torch.tensor(i + 1)),
            shared_kv=attention.KVCache(t(jc.shared_kv.k),
                                        t(jc.shared_kv.v),
                                        torch.tensor(i + 1)))
    assert flipped <= 2


def test_hybrid_rope_row_equals_the_reference_table_row():
    cfg = configs.get_smoke("zamba2_1p2b")
    cos, sin = jax.tree.map(np.asarray, jlayers.rope_frequencies(
        cfg.head_dim, cfg.max_seq, cfg.rope_theta))
    for pos in (0, 31, 255):
        c, s = hybrid._rope_at(cfg, torch.tensor(pos))
        np.testing.assert_array_equal(c.numpy()[0], cos[pos])
        np.testing.assert_array_equal(s.numpy()[0], sin[pos])


def test_hybrid_prefill_raises_as_reference(smoke_models):
    jcfg, params, cfg, model = smoke_models["zamba2_1p2b"]
    toks = _tokens(cfg, 1, 8, 13)
    with pytest.raises(NotImplementedError) as theirs:
        japi.prefill(params, jcfg, {"tokens": toks},
                     japi.init_caches(params, jcfg, 1, 16))
    with pytest.raises(NotImplementedError) as mine:
        api.prefill(model, cfg, {"tokens": toks},
                    api.init_caches(model, cfg, 1, 16))
    assert str(mine.value) == str(theirs.value)


def test_family_models_count_their_parameters(smoke_models):
    """Each model's parameters equal the config's analytic count plus the
    leaves it leaves out: norm gains, and each Mamba2 layer's conv,
    conv bias and per-head vectors."""
    for arch, (_, _, cfg, model) in smoke_models.items():
        n = sum(p.numel() for p in model.parameters())
        norms = sum(p.numel() for name, p in model.named_parameters()
                    if name.endswith(".g"))
        extra = 0
        if cfg.ssm is not None:
            s = cfg.ssm
            conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
            extra = cfg.n_layers * ((s.conv_kernel + 1) * conv_ch
                                    + 3 * s.n_heads)
        assert n == cfg.param_count() + norms + extra, arch
    olmoe = configs.get("olmoe_1b_7b")
    assert olmoe.active_param_count() < olmoe.param_count()


@pytest.mark.parametrize("arch", SERVED + ("zamba2_1p2b",))
def test_plan_warmup_shapes_match_reference(monkeypatch, arch):
    """The decode shapes warmed are the reference's: no attention shapes
    for the SSM family (no heads), the MLP only where there is a d_ff."""
    from repro.serve import decode as jdecode
    from repro.serve.plan_cache import reset_default_plan_service as jreset
    from repro_torch.serve.plan_cache import reset_default_plan_service
    monkeypatch.setenv("REPRO_SERVE_DISCRIMINANT", "flops")
    cfg, jcfg = configs.get_smoke(arch), jget_smoke(arch)
    jreset()
    reset_default_plan_service()
    try:
        want = jdecode.plan_warmup(jcfg, max_s=64)
        assert decode.plan_warmup(cfg, 64, device="cpu") == want
    finally:
        jreset()
        reset_default_plan_service()
    assert any(f == "decattn" for f, _ in want) == (cfg.family != "ssm")
