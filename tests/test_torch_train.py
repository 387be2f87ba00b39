"""The port's differentiable models against the JAX package's, on the
CPU: chunked attention with its own backward (``_ChunkedCore``) against
``jax.vjp`` of the reference's ``chunked_attention`` and against autograd
through the port's dense attention, ``api.loss_fn`` for every family's
smoke config, and the gradients of ``loss_fn`` for the ssm, hybrid and
dense families (one at S = 2048, through the chunked path).

Weights are the reference's, carried by ``repro_torch.models.convert``;
inputs are the same seeded numpy arrays. Float32 values compare at
rtol = atol = 1e-5 (``TOL``: attention outputs and gradients are O(1–10),
sums over 1024 keys in another order; a dq near 0 keeps ~5e-6 of
them). The chunked backward rounds each query head's dk and dv to
bfloat16 per key block, as the reference does, and a GQA key head sums
its query heads' rounded values, so dk and dv compare element by
element against the rounding: within one bfloat16 ulp of each summed
head's value of the reference's (|d| ≤ 2**-7·Σ|head| + ``BF16_ATOL``:
both round float32 sums that differ by ~1e-6; without GQA each value
is a bfloat16 one), and within half an ulp of the unrounded dense
route's (2**-8·Σ|head| + ``BF16_ATOL``).
``BF16_ATOL`` is 3× the worst excess measured over these bounds (7.1e-7,
a value near 0 whose float32 sums differ). Model gradients compare per
leaf at ``GRAD_TOL`` of the leaf's largest value: 3× the worst
measured, 1.04e-5 at S = 64 (mamba2's ``a_log``, summed over every
position) and 1.84e-4 at S = 2048.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import api as japi
from repro.models import attention as jattention
from repro_torch import configs
from repro_torch.models import api, attention, convert

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 2.2e-6
GRAD_TOL = {64: 3e-5, 32: 3e-5, 2048: 6e-4}


def _close_to_max(got, want, limit, name=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= limit * np.abs(want).max(), (name, err, np.abs(want).max())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------- chunked attention ---

#: (causal, window, kv heads of 4, soft-cap): causal, sliding window, GQA,
#: soft-capped and bidirectional, at S = 1024 with blocks of 256.
CHUNKED_CASES = [(True, 0, 4, 0.0), (True, 300, 4, 0.0), (True, 0, 2, 0.0),
                 (True, 0, 4, 30.0), (False, 0, 1, 0.0)]


def _chunked_inputs(seed, hkv, s=1024, h=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, s, h, d)).astype(np.float32) * 2.0
    k = rng.standard_normal((1, s, hkv, d)).astype(np.float32) * 2.0
    v = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    g = rng.standard_normal((1, s, h, d)).astype(np.float32)
    return q, k, v, g


def _acfg(causal, window, hkv, cap, h=4, d=16):
    return attention.AttnConfig(d_model=h * d, n_heads=h, n_kv_heads=hkv,
                                head_dim=d, logit_softcap=cap, window=window,
                                causal=causal)


def _port_vjp(fn, q, k, v, g):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(torch.from_numpy(g))
    return out.detach(), qt.grad, kt.grad, vt.grad


def _repeat_heads(q, *kv):
    """Each key/value array repeated to q's heads (the core's input)."""
    return [np.repeat(a, q.shape[2] // a.shape[2], axis=2) for a in kv]


def _head_magnitude(per_head, hkv):
    """Σ over each key head's query heads of |their gradient|."""
    b, s, h, d = per_head.shape
    return np.abs(np.asarray(per_head).reshape(b, s, hkv, h // hkv, d)) \
        .sum(axis=3)


def _within_rounding(got, want, magnitude, ulps) -> bool:
    """|got − want| ≤ ulps · 2**-7 · magnitude + BF16_ATOL, element by
    element (2**-7 |x| is one bfloat16 ulp of x, or more)."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    return bool((err <= ulps * 2 ** -7 * magnitude + BF16_ATOL).all())


@pytest.mark.parametrize("causal,window,hkv,cap", CHUNKED_CASES)
def test_chunked_core_matches_reference_vjp(causal, window, hkv, cap):
    q, k, v, g = _chunked_inputs(0, hkv)
    cfg = _acfg(causal, window, hkv, cap)
    jcfg = jattention.AttnConfig(*cfg)
    out, dq, dk, dv = _port_vjp(lambda *a: attention.chunked_attention(
        cfg, *a, block=256), q, k, v, g)
    jout, vjp = jax.vjp(lambda *a: jattention.chunked_attention(
        jcfg, *a, block=256), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(g))
    kq, vq = _repeat_heads(q, k, v)
    _, head_vjp = jax.vjp(lambda *a: jattention._chunked_core(
        *a, q.shape[-1] ** -0.5, causal, window, cap, 256),
        *(jnp.asarray(a) for a in (q, kq, vq)))
    _, hdk, hdv = head_vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)
    np.testing.assert_allclose(dq.numpy(), _np(jdq), **TOL)
    assert _within_rounding(dk, _np(jdk), _head_magnitude(_np(hdk), hkv), 1)
    assert _within_rounding(dv, _np(jdv), _head_magnitude(_np(hdv), hkv), 1)
    if hkv == q.shape[2]:          # one query head a key head: bf16 values
        assert all(torch.equal(x, x.bfloat16().float()) for x in (dk, dv))


def _held_against_dense(out, dq, dk, dv, dense, magnitudes) -> bool:
    """The chunked route against autograd through the dense attention
    (the plain version): ``TOL`` for the output and dq, half a bfloat16
    ulp of each query head's dense gradient (``magnitudes``) for the
    bf16-rounded key gradients."""
    dout, ddq, ddk, ddv = dense
    ok = all(np.allclose(a.numpy(), b.numpy(), **TOL)
             for a, b in ((out, dout), (dq, ddq)))
    for a, b, m in zip((dk, dv), (ddk, ddv), magnitudes):
        ok &= _within_rounding(a, b, m, 0.5)
    return ok


@pytest.mark.parametrize("causal,window,hkv,cap", CHUNKED_CASES)
def test_chunked_core_matches_dense_autograd_and_rejects_a_dropped_block(
        causal, window, hkv, cap):
    q, k, v, g = _chunked_inputs(1, hkv)
    cfg = _acfg(causal, window, hkv, cap)
    chunked = _port_vjp(lambda *a: attention.chunked_attention(
        cfg, *a, block=256), q, k, v, g)
    dense = _port_vjp(lambda *a: attention._dense_attention(cfg, *a),
                      q, k, v, g)
    mha = cfg._replace(n_kv_heads=cfg.n_heads)
    _, _, hdk, hdv = _port_vjp(lambda *a: attention._dense_attention(
        mha, *a), q, *_repeat_heads(q, k, v), g)
    magnitudes = [_head_magnitude(x.numpy(), hkv) for x in (hdk, hdv)]
    assert _held_against_dense(*chunked, dense, magnitudes)
    dv = chunked[3].clone()
    dv[:, 256:512] = 0                     # one key block's dv dropped
    assert not _held_against_dense(*chunked[:3], dv, dense, magnitudes)


def test_chunked_attention_in_bf16_and_its_block_check():
    q, k, v, g = _chunked_inputs(2, 2, s=512)
    cfg = _acfg(True, 0, 2, 0.0)
    qt, kt, vt = (torch.tensor(a).bfloat16().requires_grad_(True)
                  for a in (q, k, v))
    out = attention.chunked_attention(cfg, qt, kt, vt, block=256)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == qt.grad.dtype == kt.grad.dtype == torch.bfloat16
    want = attention._dense_attention(cfg, *(t.detach().float()
                                             for t in (qt, kt, vt)))
    _close_to_max(out.detach().float(), want, 2 ** -6)
    with pytest.raises(ValueError, match="multiple of the block"):
        attention.chunked_attention(cfg, qt[:, :300], kt[:, :300],
                                    vt[:, :300], block=256)


# -------------------------------------------------------------- loss_fn ---

def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _pair(jcfg, cfg, seed=0):
    params, _ = japi.init(jax.random.PRNGKey(seed), jcfg)
    model = convert.from_reference_params(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return params, model


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_fn_matches_reference(arch):
    """Every family's smoke config; the dense ones weigh the positions
    with a ``loss_mask`` (a quarter of them off)."""
    jcfg, cfg = jget_smoke(arch), configs.get_smoke(arch)
    params, model = _pair(jcfg, cfg)
    batch = _batch(cfg, 2, 24, seed=3)
    if cfg.family == "dense":
        batch["loss_mask"] = (np.arange(24)[None, :] % 4 != 0) \
            .astype(np.float32).repeat(2, axis=0)
    total, metrics = api.loss_fn(model, cfg, batch)
    jtotal, jmetrics = japi.loss_fn(params, jcfg, {
        k: jnp.asarray(v) for k, v in batch.items()})
    assert not total.requires_grad
    np.testing.assert_allclose(float(total), float(jtotal), **TOL)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), **TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]),
                               **TOL)


def _grads_match(jcfg, cfg, b, s, seed=0):
    params, model = _pair(jcfg, cfg, seed)
    batch = _batch(cfg, b, s, seed=seed + 5)
    for p in model.parameters():
        p.requires_grad_(True)
    total, _ = api.loss_fn(model, cfg, batch)
    total.backward()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtotal, jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, jbatch)[0]))(params)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    want = convert._reference_state(jax.tree.map(np.asarray, jgrads), cfg)
    for name, p in model.named_parameters():
        _close_to_max(p.grad.numpy(), want[name], GRAD_TOL[s], name)


@pytest.mark.parametrize("arch,b,s", [
    ("mamba2_370m", 2, 64), ("zamba2_1p2b", 2, 64), ("yi_9b", 2, 64),
    ("zamba2_1p2b", 1, 2048)])
def test_loss_gradients_match_reference(arch, b, s):
    """S = 2048 takes the chunked attention in zamba2's shared block
    (window 32 at smoke size)."""
    _grads_match(jget_smoke(arch), configs.get_smoke(arch), b, s)


def test_softcapped_head_over_a_padded_vocab_differentiates():
    """gemma2's final soft-cap over a vocab of 250 (padded to 256): the pad
    mask is written out of place, so the backward through tanh works."""
    jcfg = dataclasses.replace(jget_smoke("gemma2_9b"), vocab=250)
    cfg = dataclasses.replace(configs.get_smoke("gemma2_9b"), vocab=250)
    assert cfg.final_softcap > 0 and cfg.padded_vocab == 256
    _grads_match(jcfg, cfg, 2, 32)


# ------------------------------------------- chip_smoke's device time ---

def test_chip_smoke_device_time_counts_only_device_entries():
    """``device_busy_ms`` sums the CUDA entries of a profile (kernels,
    memcpy, memset) and nothing host-side: an ATen op, a ``repro_`` range
    and a device-side user annotation only repeat their kernels' time."""
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def event(key, device, us, annotation=False):
        return SimpleNamespace(key=key, device_type=device,
                               self_device_time_total=us,
                               is_user_annotation=annotation)

    events = [
        event("aten::mm", DeviceType.CPU, 300.0),
        event("repro_flash_attention", DeviceType.CPU, 120.0),
        event("cudaLaunchKernel", DeviceType.CPU, 0.0),
        event("sm90_xmma_gemm_bf16", DeviceType.CUDA, 300.0),
        event("flash_attention_tc_kernel", DeviceType.CUDA, 120.0),
        event("Memcpy HtoD (Pageable -> Device)", DeviceType.CUDA, 5.0),
        event("Memset (Device)", DeviceType.CUDA, 1.5),
        event("repro_flash_attention", DeviceType.CUDA, 121.0,
              annotation=True),
    ]
    assert mod.device_busy_ms(events) == pytest.approx(0.4265)
    assert mod.device_busy_ms(events[:3]) == 0


@pytest.mark.parametrize("arch", ["yi_9b", "zamba2_1p2b", "whisper_tiny"])
def test_remat_settings_give_the_same_gradients(arch):
    """``remat`` changes what the backward pass recomputes, not what it
    computes: ``dots`` and ``full`` give ``none``'s loss and gradients
    (the same float32 operations, run again), and a setting outside
    none | dots | full raises."""
    cfg = configs.get_smoke(arch)
    batch = _batch(cfg, 2, 32, seed=4)
    grads = {}
    for remat in ("none", "dots", "full"):
        model = api.init(dataclasses.replace(cfg, remat=remat), seed=0,
                         device="cpu")
        for p in model.parameters():
            p.requires_grad_(True)
        total, _ = api.loss_fn(model, dataclasses.replace(cfg, remat=remat),
                               batch)
        total.backward()
        grads[remat] = (float(total.detach()), {n: p.grad for n, p in
                                       model.named_parameters()})
    for remat in ("dots", "full"):
        assert grads[remat][0] == pytest.approx(grads["none"][0], rel=1e-6)
        for name, g in grads["none"][1].items():
            np.testing.assert_allclose(grads[remat][1][name].numpy(),
                                       g.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{remat} {name}")
    with pytest.raises(ValueError, match="remat"):
        api.loss_fn(model, dataclasses.replace(cfg, remat="some"), batch)
