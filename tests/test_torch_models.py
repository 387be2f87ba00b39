"""The port's model stack against the JAX package's, on the CPU.

Same seeded numpy inputs into both packages; the reference's weights are
carried into the port by ``repro_torch.models.convert``. Float32 compares
at rtol = atol = 1e-4, as in tests/test_kernels.py. KV caches are stored
in bfloat16 by both: the float32 K/V the two compute differ by ~1e-7 of
the O(1) terms summed, so a value next to a rounding boundary may land
one bfloat16 ulp apart and a value near zero keeps that absolute
difference; caches compare at rtol = 2**-7 (one ulp), atol = 1e-5. The
flash route runs the reference's Pallas kernel in interpret mode and the
port's plain version (CPU tensors); the kernel itself is checked on the
card by tests/test_torch_gpu.py and chip_smoke.py. Decode, the training
forward and generation are compared in tests/test_torch_serve.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.models import api as japi
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import api, attention, convert, layers, transformer

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


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


# --------------------------------------------------------------- configs ---

#: The port's own ModelConfig fields, which the reference lacks: the
#: hybrid's published shared block, opt-in; at their defaults (every
#: preset) the port computes the reference's block.
PORT_ONLY_FIELDS = ("shared_block", "num_mem_blocks", "adapter_rank",
                    "attn_adapters", "hybrid_layers")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    mine = (configs.get_smoke if smoke else configs.get)(arch)
    theirs = (jget_smoke if smoke else jget)(arch)
    for field in dataclasses.fields(mine):
        if field.name in PORT_ONLY_FIELDS:
            assert not hasattr(theirs, field.name), field.name
            assert getattr(mine, field.name) == field.default, field.name
            continue
        assert getattr(mine, field.name) == getattr(theirs, field.name), \
            field.name
    assert mine.padded_vocab == theirs.padded_vocab
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    assert list(mine.layer_windows()) == [int(w) for w in
                                          theirs.layer_windows()]
    assert mine.attn_cfg._asdict() == theirs.attn_cfg._asdict()


def test_config_aliases_and_shapes():
    assert configs.get("yi-9b") == configs.get("yi_9b")
    assert configs.SHAPES["prefill_32k"].seq_len == 32768
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.get("llama_7b")


# ---------------------------------------------------------------- layers ---

@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_reference(plus_one):
    rng = np.random.default_rng(1)
    x, g = _rand(rng, 3, 5, 64, scale=3.0), _rand(rng, 64)
    norm = layers.RMSNorm(64, device="cpu", dtype=torch.float32)
    norm.g.copy_(torch.from_numpy(g))
    got = layers.rmsnorm(norm, torch.from_numpy(x), plus_one=plus_one)
    want = jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x),
                           plus_one=plus_one)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_rmsnorm_bf16_computes_in_f32_and_casts_back():
    rng = np.random.default_rng(2)
    x = _rand(rng, 4, 32, scale=5.0)
    norm = layers.RMSNorm(32, device="cpu", dtype=torch.bfloat16)
    got = layers.rmsnorm(norm, torch.from_numpy(x).to(torch.bfloat16))
    want = jlayers.rmsnorm({"g": jnp.ones((32,), jnp.bfloat16)},
                           jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("theta", [10000.0, 5e6])
def test_rope_rotates_halves_like_reference(theta):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 40, (2, 7))
    cos, sin = layers.rope_frequencies(16, 40, theta)
    jcos, jsin = jlayers.rope_frequencies(16, 40, theta)
    np.testing.assert_allclose(cos.numpy(), _np(jcos), **TOL)
    got = layers.apply_rope(torch.from_numpy(x), cos, sin,
                            torch.from_numpy(pos))
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_glu_mlp_matches_reference(activation):
    gen = torch.Generator().manual_seed(0)
    mod = layers.GluMLP(32, 48, generator=gen, device="cpu",
                        dtype=torch.float32)
    x = _rand(np.random.default_rng(4), 2, 5, 32)
    jp = {k: {"w": jnp.asarray(getattr(mod, k).w.numpy())}
          for k in ("gate", "up", "down")}
    got = layers.glu_mlp(mod, torch.from_numpy(x), activation)
    want = jlayers.glu_mlp(jp, jnp.asarray(x), activation)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mlp_softcap_and_embed_match_reference():
    gen = torch.Generator().manual_seed(1)
    mod = layers.MLP(32, 48, generator=gen, device="cpu",
                     dtype=torch.float32)
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 5, 32)
    jp = {k: {"w": jnp.asarray(getattr(mod, k).w.numpy())}
          for k in ("up", "down")}
    np.testing.assert_allclose(layers.mlp(mod, torch.from_numpy(x)).numpy(),
                               _np(jlayers.mlp(jp, jnp.asarray(x))), **TOL)
    big = _rand(rng, 100, scale=80.0)
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(big), 30.0).numpy(),
        _np(jlayers.softcap(jnp.asarray(big), 30.0)), **TOL)
    assert torch.equal(layers.softcap(torch.from_numpy(big), 0.0),
                       torch.from_numpy(big))
    emb = layers.Embed(50, 8, generator=gen, device="cpu",
                       dtype=torch.float32)
    toks = rng.integers(0, 50, (3, 4))
    np.testing.assert_array_equal(
        layers.embed(emb, torch.from_numpy(toks)).numpy(),
        _np(jlayers.embed({"w": jnp.asarray(emb.w.numpy())},
                          jnp.asarray(toks))))


def test_init_draws_the_reference_distributions_from_the_seed():
    cfg = configs.get_smoke("yi_9b")
    a = api.init(cfg, seed=3, device="cpu")
    b = api.init(cfg, seed=3, device="cpu")
    c = api.init(cfg, seed=4, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if name.endswith(".g"):
            assert torch.equal(x, torch.ones_like(x)), name
        else:
            assert not torch.equal(x, z), name
    assert abs(float(a.embed.w.std()) - 0.02) < 0.002
    wq = a.blocks[0].attn.wq.w
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.02
    assert a.lm_head.w.shape == (cfg.d_model, cfg.padded_vocab)


def test_init_raises_without_a_card_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; init rightly uses it")
    cfg = configs.get_smoke("yi_9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference_params({}, cfg)
    assert api.init(cfg, device="cpu").embed.w.device.type == "cpu"


def test_convert_raises_on_missing_unused_and_misshaped_leaves(smoke_models):
    jcfg, params, cfg, _ = smoke_models["yi_9b"]
    tree = jax.tree.map(np.asarray, params)
    no_head = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match=r"missing \['lm_head.w'\]"):
        convert.from_reference_params(no_head, cfg, device="cpu")
    extra = dict(tree, bias={"b": np.zeros(3)})
    with pytest.raises(ValueError, match=r"unused \['bias.b'\]"):
        convert.from_reference_params(extra, cfg, device="cpu")
    bad = dict(tree, final_norm={"g": np.zeros(cfg.d_model + 1)})
    with pytest.raises(ValueError, match="final_norm.g: reference shape"):
        convert.from_reference_params(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="assembled by models.encdec"):
        transformer.init(dataclasses.replace(cfg, family="encdec"), None,
                         device="meta")


def test_convert_raises_on_a_hybrid_tree_missing_a_shared_leaf():
    """zamba2's tree holds the unstacked ``shared`` block beside the
    stacked ``blocks``: a missing shared leaf, or blocks cut to the wrong
    number of layers, raises."""
    jcfg = jget_smoke("zamba2_1p2b")
    params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    cfg = configs.get_smoke("zamba2_1p2b")
    model = convert.from_reference_params(tree, cfg, device="cpu")
    np.testing.assert_array_equal(model.shared.attn.wq.w.numpy(),
                                  tree["shared"]["attn"]["wq"]["w"])
    np.testing.assert_array_equal(model.blocks[3].mixer.conv_w.numpy(),
                                  tree["blocks"]["mixer"]["conv_w"][3])
    shared = {k: v for k, v in tree["shared"].items() if k != "mlp"}
    with pytest.raises(ValueError, match=r"missing \['shared.mlp.down.w'"):
        convert.from_reference_params(dict(tree, shared=shared), cfg,
                                      device="cpu")
    cut = jax.tree.map(lambda a: a[:2], tree["blocks"])
    with pytest.raises(ValueError, match="is not the 4 layers"):
        convert.from_reference_params(dict(tree, blocks=cut), cfg,
                                      device="cpu")


# ------------------------------------------------------------- attention ---

def _attention_pair(smoke_models, arch, window):
    jcfg, params, cfg, model = smoke_models[arch]
    acfg = cfg.attn_cfg._replace(window=window)
    jacfg = jcfg.attn_cfg._replace(window=window)
    jp = jax.tree.map(lambda a: a[0], params["blocks"])["attn"]
    return acfg, jacfg, model.blocks[0].attn, jp, cfg


@pytest.mark.parametrize("s,flash", [(256, True), (100, False)])
@pytest.mark.parametrize("arch,window", [("yi_9b", 0), ("gemma2_9b", 32)])
def test_attention_apply_train_routes_like_reference(
        smoke_models, monkeypatch, arch, window, s, flash):
    acfg, jacfg, p, jp, cfg = _attention_pair(smoke_models, arch, window)
    x = _rand(np.random.default_rng(s), 2, s, cfg.d_model)
    rope = layers.rope_frequencies(cfg.head_dim, s, cfg.rope_theta)
    jrope = jlayers.rope_frequencies(cfg.head_dim, s, cfg.rope_theta)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(attention.kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, (k, v) = attention.apply_train(p, acfg, torch.from_numpy(x),
                                        rope=rope, return_kv=True,
                                        differentiable=False)
    want, (jk, jv) = jattention.apply_train(jp, jacfg, jnp.asarray(x),
                                            rope=jrope, return_kv=True,
                                            differentiable=False)
    assert len(calls) == (1 if flash else 0)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(k.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)


def test_differentiable_chunked_route_is_not_ported(smoke_models,
                                                   monkeypatch):
    """Differentiable attention at S = 2048 takes the chunked route (no
    flash call), as the reference does, and agrees with it; prefill still
    takes flash. The name dates from when the route raised here (it had
    not been ported); it is kept so that the test's history reads on."""
    acfg, jacfg, p, jp, cfg = _attention_pair(smoke_models, "yi_9b", 0)
    x = _rand(np.random.default_rng(7), 1, 2048, cfg.d_model)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(attention.kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = attention.apply_train(p, acfg, torch.from_numpy(x))
    want = jattention.apply_train(jp, jacfg, jnp.asarray(x))
    assert calls == []
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    attention.apply_train(p, acfg, torch.from_numpy(x), differentiable=False)
    assert calls == [1]


def test_pv_wo_output_matches_reference_repeat(smoke_models):
    _, _, p, jp, cfg = _attention_pair(smoke_models, "yi_9b", 0)
    rng = np.random.default_rng(6)
    b, kk, h, hkv, hd = 2, 9, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pa = np.abs(_rand(rng, b, h, 1, kk))
    v = _rand(rng, b, kk, hkv, hd)
    vq = np.repeat(v, h // hkv, axis=2)
    got = attention.pv_wo_output(torch.from_numpy(pa), torch.from_numpy(v),
                                 p.wo, h, hd, torch.float32)
    want = jattention.pv_wo_output(jnp.asarray(pa), jnp.asarray(vq),
                                   jp["wo"], h, hd, jnp.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert attention.planned_pv_right_first(1, kk, hd, cfg.d_model) is False


# ----------------------------------------------------------------- model ---

def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_prefill_logits_and_caches_match_reference(smoke_models, arch):
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 256, 7)
    want, jc = japi.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                            japi.init_caches(params, jcfg, 2, 260))
    got, caches = api.prefill(model, cfg, {"tokens": toks},
                              api.init_caches(model, cfg, 2, 260))
    assert got.shape == (2, 256, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert caches.kv.k.dtype == torch.bfloat16
    assert int(caches.kv.length) == int(jc.kv.length[0]) == 256
    np.testing.assert_allclose(caches.kv.k.float().numpy(), _np(jc.kv.k),
                               **CACHE_TOL)
    np.testing.assert_allclose(caches.kv.v.float().numpy(), _np(jc.kv.v),
                               **CACHE_TOL)
