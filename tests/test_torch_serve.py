"""The port's serving path against the JAX package's, on the CPU.

Decode steps, the training forward and ``generate`` of the dense smoke
configs, with the reference's weights carried into the port by
``repro_torch.models.convert`` and the same seeded numpy tokens into
both. Float32 logits compare at rtol = atol = 1e-4, as in
tests/test_kernels.py; bfloat16 KV caches at rtol = 2**-7 (one ulp),
atol = 1e-5, as in tests/test_torch_models.py. Greedy generation must be
token-identical. The reference runs with ``REPRO_SERVE_PLANNER=0``: its
plan cache is not ported, and the port decodes with the left association
that setting selects.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import api as japi
from repro.runtime.supervisor import StragglerMonitor as JStragglerMonitor
from repro.serve.decode import generate as jgenerate
from repro_torch import configs
from repro_torch.models import api, attention, convert, transformer
from repro_torch.runtime import StragglerMonitor
from repro_torch.serve import decode

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def smoke_models():
    """arch → (reference cfg, reference params, port cfg, port model)."""
    out = {}
    for arch in ("yi_9b", "gemma2_9b"):
        jcfg = jget_smoke(arch)
        params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke(arch)
        model = convert.from_reference_params(
            jax.tree.map(np.asarray, params), cfg, device="cpu")
        out[arch] = (jcfg, params, cfg, model)
    return out


def _port_caches(jc):
    """The reference's caches as the port's (bfloat16 values unchanged)."""
    def t(a):
        return torch.tensor(_np(a)).to(torch.bfloat16)
    return transformer.LayerCaches(kv=attention.KVCache(
        t(jc.kv.k), t(jc.kv.v), int(jc.kv.length[0])))


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_decode_from_the_same_cache_matches_reference(smoke_models, arch):
    """Window 32 of gemma2's local layers bites at position 40."""
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 40, 8)
    _, jc = japi.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                         japi.init_caches(params, jcfg, 2, 48))
    caches = _port_caches(jc)
    for step in range(2):
        nt = _tokens(cfg, 2, 1, 9 + step)
        want, jc = japi.decode_step(params, jcfg, jnp.asarray(nt), jc)
        got, caches = api.decode_step(model, cfg, nt, caches)
        assert got.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        assert caches.kv.length == int(jc.kv.length[0]) == 41 + step
        np.testing.assert_allclose(caches.kv.k.float().numpy(),
                                   _np(jc.kv.k), **CACHE_TOL)


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_forward_train_matches_reference(smoke_models, arch):
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 64, 10)
    want, jaux = japi.forward_train(params, jcfg, {"tokens": toks})
    got, aux = api.forward_train(model, cfg, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ["glm4_9b", "gemma2_9b", "phi3_mini"])
def test_decode_matches_teacher_forced_forward(arch):
    """Port-only counterpart of tests/test_models.py: token-by-token
    decode equals the full forward up to bf16 cache storage (2e-2)."""
    cfg = configs.get_smoke(arch)
    model = api.init(cfg, seed=0, device="cpu")
    toks = _tokens(cfg, 1, 8, 3)
    full, _ = api.forward_train(model, cfg, {"tokens": toks})
    caches = api.init_caches(model, cfg, 1, 32)
    outs = []
    for i in range(8):
        step, caches = api.decode_step(model, cfg, toks[:, i:i + 1], caches)
        outs.append(step[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_padded_vocab_columns_are_masked():
    cfg = dataclasses.replace(configs.get_smoke("phi3_mini"), vocab=250)
    assert cfg.padded_vocab == 256
    model = api.init(cfg, seed=0, device="cpu")
    logits, _ = api.forward_train(model, cfg, {"tokens": [[1, 2, 3]]})
    assert logits.shape == (1, 3, 256)
    assert bool((logits[..., 250:] == -1e30).all())
    assert bool((logits[..., :250] > -1e29).all())



@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_generate_is_token_identical_to_reference(smoke_models, monkeypatch,
                                                  arch):
    """Window 32 of gemma2's local layers bites past position 32."""
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    jcfg, params, cfg, model = smoke_models[arch]
    prompt = _tokens(cfg, 2, 30, 11)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt),
                                max_new=8, max_s=40))
    got = decode.generate(model, cfg, prompt, max_new=8, max_s=40)
    assert got.shape == (2, 38) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_greedy_consistency(smoke_models):
    """Port-only counterpart of tests/test_distribution.py: re-scoring the
    generated sequence predicts its last token greedily."""
    _, _, cfg, model = smoke_models["yi_9b"]
    out = decode.generate(model, cfg, [[5, 9, 2]], max_new=4, max_s=16)
    assert out.shape == (1, 7)
    logits, _ = api.forward_train(model, cfg, {"tokens": out[:, :-1]})
    assert int(torch.argmax(logits[0, -1])) == int(out[0, -1])


def test_sampling_draws_from_the_seeded_generator(smoke_models):
    _, _, cfg, model = smoke_models["gemma2_9b"]
    prompt = _tokens(cfg, 2, 4, 12)
    runs = [decode.generate(model, cfg, prompt, max_new=6, temperature=1.0,
                            seed=seed) for seed in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab


def test_serve_step_and_monitor(smoke_models):
    _, _, cfg, model = smoke_models["yi_9b"]
    caches = api.init_caches(model, cfg, 2, 8)
    state = decode.ServeState(caches, torch.tensor([[1], [2]]),
                              torch.Generator().manual_seed(0))
    step = decode.make_serve_step(cfg)
    state, nxt = step(state, model)
    assert nxt.shape == (2, 1) and state.caches.kv.length == 1
    assert torch.equal(state.last_tokens, nxt)
    assert decode.plan_warmup(cfg, 8) == []
    monitor = StragglerMonitor()
    decode.generate(model, cfg, [[1, 2]], max_new=3, monitor=monitor)
    assert monitor.n == 3


def test_straggler_monitor_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.0, 1.05, 5.0, 1.0, 3.0, 0.95]
    mine, theirs = StragglerMonitor(warmup_steps=3), \
        JStragglerMonitor(warmup_steps=3)
    flags = [mine.observe(i, t) for i, t in enumerate(times)]
    assert flags == [theirs.observe(i, t) for i, t in enumerate(times)]
    assert mine.flagged == theirs.flagged == [6, 8]
    assert mine.ema == pytest.approx(theirs.ema)


def test_decode_past_the_cache_raises(smoke_models):
    _, _, cfg, model = smoke_models["yi_9b"]
    caches = api.init_caches(model, cfg, 1, 2)
    for t in (1, 2):
        _, caches = api.decode_step(model, cfg, [[t]], caches)
    with pytest.raises(ValueError, match="KV cache full"):
        api.decode_step(model, cfg, [[3]], caches)
