"""The port's encdec (whisper-tiny) and vlm (InternVL2-76B) families
against the JAX package's, on the CPU.

Same seeded numpy inputs and the same weights go through both packages
at smoke size: the reference's parameters are carried into the port by
``repro_torch.models.convert``. Float32 compares at rtol = atol = 1e-4,
as in tests/test_kernels.py. Both packages store KV caches and the
encdec family's cross K/V in bfloat16; the float32 values the two
compute differ by ~1e-7 of the O(1) terms summed, so a value next to a
rounding boundary may land one bfloat16 ulp apart: caches compare at
``CACHE_TOL`` (rtol = 2**-7, one ulp, atol = 1e-5), as in
tests/test_torch_families.py. The vlm prefill at P + S = 256 takes the
flash route: the reference's Pallas kernel in interpret mode, the port's
plain version (CPU tensors). Frames and vision embeddings are standard
normals from ``numpy.random.default_rng``, as tests/test_models.py draws
them.
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
from repro.models import encdec as jencdec
from repro.serve.decode import generate as jgenerate
from repro_torch import configs
from repro_torch.models import api, attention, convert, encdec, transformer
from repro_torch.serve import decode

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-5)
ARCHS = ("whisper_tiny", "internvl2_76b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _inputs(cfg, b, seed):
    """The family's stub frontend input: frames (B, S_enc, d) for encdec,
    vision embeddings (B, P, d) for vlm."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {"vision_embeds": rng.standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)}


def _batch(cfg, toks, seed):
    return dict(_inputs(cfg, toks.shape[0], seed), tokens=toks)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _bf16(a):
    return torch.tensor(_np(a)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def smoke_models():
    """arch → (reference cfg, reference params, port cfg, port model)."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_smoke(arch)
        params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke(arch)
        model = convert.from_reference_params(
            jax.tree.map(np.asarray, params), cfg, device="cpu")
        out[arch] = (jcfg, params, cfg, model)
    return out


# ----------------------------------------------------------- the modules ---

@pytest.mark.parametrize("n,d", [(64, 64), (1500, 384)])
def test_sinusoid_is_the_references_sin_then_cos(n, d):
    got = encdec._sinusoid(n, d)
    want = _np(jencdec._sinusoid(n, d))
    assert got.shape == (n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[0, : d // 2].numpy(), 0.0)
    np.testing.assert_array_equal(got[0, d // 2:].numpy(), 1.0)


def test_cross_attention_and_project_kv_match_reference(smoke_models):
    """Every encoder position visible to every query: no causal mask (a
    query of 5 positions against 64 keys), GQA heads of the vlm config
    included."""
    for arch in ARCHS:
        jcfg, params, cfg, model = smoke_models[arch]
        stack = "decoder" if cfg.family == "encdec" else "blocks"
        jp = jax.tree.map(lambda a: a[1], params[stack])
        jp = jp["cross"] if cfg.family == "encdec" else jp["attn"]
        block = getattr(model, stack)[1]
        p = block.cross if cfg.family == "encdec" else block.attn
        rng = np.random.default_rng(1)
        enc = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
        x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
        k, v = attention.project_kv(p, cfg.attn_cfg, torch.from_numpy(enc))
        jk, jv = jattention.project_kv(jp, jcfg.attn_cfg, jnp.asarray(enc))
        assert k.shape == (2, 64, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(k.numpy(), _np(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)
        got = attention.apply_cross(p, cfg.attn_cfg, torch.from_numpy(x), k,
                                    v)
        want = jattention.apply_cross(jp, jcfg.attn_cfg, jnp.asarray(x), jk,
                                      jv)
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_encoder_matches_reference(smoke_models):
    jcfg, params, cfg, model = smoke_models["whisper_tiny"]
    frames = _inputs(cfg, 2, 3)["frames"]
    got = encdec.encode(model, cfg, torch.from_numpy(frames))
    want = jencdec.encode(params, jcfg, jnp.asarray(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------- models ---

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_reference(smoke_models, arch):
    """vlm: the logits cover the P prefix positions and the S tokens."""
    jcfg, params, cfg, model = smoke_models[arch]
    batch = _batch(cfg, _tokens(cfg, 2, 40, 10), 11)
    want, jaux = japi.forward_train(params, jcfg, _jbatch(batch))
    got, aux = api.forward_train(model, cfg, batch)
    s = 40 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    assert got.shape == (2, s, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert float(aux) == float(jaux) == 0.0


def test_vlm_prefix_is_not_scaled_by_the_embedding_scale(smoke_models):
    """With ``embed_scale`` on, the tokens are scaled by sqrt(d) and the
    vision prefix is not, in both packages; the prefix's positions lead."""
    jcfg, params, cfg, model = smoke_models["internvl2_76b"]
    jcfg = dataclasses.replace(jcfg, embed_scale=True)
    cfg = dataclasses.replace(cfg, embed_scale=True)
    batch = _batch(cfg, _tokens(cfg, 2, 24, 12), 13)
    want, _ = japi.forward_train(params, jcfg, _jbatch(batch))
    got, _ = api.forward_train(model, cfg, batch)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    x = transformer._embed(cfg, model, torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["vision_embeds"]))
    p = cfg.vision_tokens
    np.testing.assert_array_equal(x[:, :p].numpy(), batch["vision_embeds"])
    np.testing.assert_allclose(
        x[:, p:].numpy(), model.embed.w[batch["tokens"]].numpy()
        * cfg.d_model ** 0.5, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(smoke_models,
                                                   monkeypatch, arch):
    """vlm: P + S = 8 + 248 = 256 positions take flash once per layer and
    fill the cache to 256. encdec: the teacher-forced logits, and the
    caches handed back unchanged, as the reference's contract says."""
    jcfg, params, cfg, model = smoke_models[arch]
    s = 256 - cfg.vision_tokens if cfg.family == "vlm" else 48
    batch = _batch(cfg, _tokens(cfg, 2, s, 7), 8)
    calls = []
    real = attention.kops.flash_attention
    monkeypatch.setattr(attention.kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jc = japi.init_caches(params, jcfg, 2, 260,
                          batch_inputs=_jbatch(_inputs(cfg, 2, 8)))
    want, jc = japi.prefill(params, jcfg, _jbatch(batch), jc)
    caches = api.init_caches(model, cfg, 2, 260,
                             batch_inputs=_inputs(cfg, 2, 8))
    got, out = api.prefill(model, cfg, batch, caches)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    if cfg.family == "encdec":
        assert got.shape == (2, s, cfg.vocab) and not calls
        assert out is caches and int(out.self_kv.length) == 0
        assert int(jc.self_kv.length[0]) == 0
        assert not bool(out.self_kv.k.any()) and not bool(out.self_kv.v.any())
        return
    assert got.shape == (2, 256, cfg.vocab) and len(calls) == cfg.n_layers
    assert int(out.kv.length) == int(jc.kv.length[0]) == 256
    assert out.kv.k.dtype == torch.bfloat16
    np.testing.assert_allclose(out.kv.k.float().numpy(), _np(jc.kv.k),
                               **CACHE_TOL)
    np.testing.assert_allclose(out.kv.v.float().numpy(), _np(jc.kv.v),
                               **CACHE_TOL)


def test_init_caches_store_the_cross_kv_in_bf16_as_reference(smoke_models):
    jcfg, params, cfg, model = smoke_models["whisper_tiny"]
    frames = _inputs(cfg, 2, 4)
    jc = japi.init_caches(params, jcfg, 2, 24,
                          batch_inputs=_jbatch(frames))
    caches = api.init_caches(model, cfg, 2, 24, batch_inputs=frames)
    shape = (cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    assert caches.cross_k.shape == caches.cross_v.shape == shape
    assert caches.cross_k.dtype == caches.cross_v.dtype == torch.bfloat16
    np.testing.assert_allclose(caches.cross_k.float().numpy(),
                               _np(jc.cross_k), **CACHE_TOL)
    np.testing.assert_allclose(caches.cross_v.float().numpy(),
                               _np(jc.cross_v), **CACHE_TOL)
    assert caches.self_kv.k.shape == tuple(jc.self_kv.k.shape) == (
        cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    assert int(caches.self_kv.length) == 0 and \
        caches.self_kv.right_first is False
    with pytest.raises(ValueError, match="needs batch_inputs"):
        api.init_caches(model, cfg, 2, 24)


def _port_caches(cfg, jc):
    """The reference's caches as the port's (bfloat16 values unchanged)."""
    if cfg.family == "encdec":
        kv = jc.self_kv
        return encdec.EncDecCaches(
            self_kv=attention.KVCache(_bf16(kv.k), _bf16(kv.v),
                                      torch.tensor(int(kv.length[0]))),
            cross_k=_bf16(jc.cross_k), cross_v=_bf16(jc.cross_v))
    return transformer.LayerCaches(kv=attention.KVCache(
        _bf16(jc.kv.k), _bf16(jc.kv.v), torch.tensor(int(jc.kv.length[0]))))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_same_cache_matches_reference(smoke_models, arch):
    """Eight steps from the reference's caches: encdec from its empty self
    caches and bf16 cross K/V, vlm from a prefill of its prefix and 24
    tokens. Each step's logits and self K/V against the reference's."""
    jcfg, params, cfg, model = smoke_models[arch]
    inputs = _jbatch(_inputs(cfg, 2, 5))
    jc = japi.init_caches(params, jcfg, 2, 48, batch_inputs=inputs)
    start = 0
    if cfg.family == "vlm":
        toks = jnp.asarray(_tokens(cfg, 2, 24, 6))
        _, jc = japi.prefill(params, jcfg, dict(inputs, tokens=toks), jc)
        start = cfg.vision_tokens + 24
    caches = _port_caches(cfg, jc)
    for step in range(8):
        nt = _tokens(cfg, 2, 1, 20 + step)
        want, jc = japi.decode_step(params, jcfg, jnp.asarray(nt), jc)
        got, caches = api.decode_step(model, cfg, nt, caches)
        assert got.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        kv, jkv = ((caches.self_kv, jc.self_kv) if cfg.family == "encdec"
                   else (caches.kv, jc.kv))
        assert int(kv.length) == int(jkv.length[0]) == start + step + 1
        np.testing.assert_allclose(kv.k.float().numpy(), _np(jkv.k),
                                   **CACHE_TOL)
        np.testing.assert_allclose(kv.v.float().numpy(), _np(jkv.v),
                                   **CACHE_TOL)
    if cfg.family == "encdec":   # the cross K/V are read, never written
        np.testing.assert_array_equal(caches.cross_k.float().numpy(),
                                      _np(jc.cross_k))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_is_token_identical_to_reference(smoke_models, monkeypatch,
                                                  arch):
    """encdec: the frames go to init_caches through ``batch_inputs``; the
    prompt fills the self caches token by token."""
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    jcfg, params, cfg, model = smoke_models[arch]
    prompt = _tokens(cfg, 2, 20, 14)
    inputs = _inputs(cfg, 2, 15) if cfg.family == "encdec" else None
    want = np.asarray(jgenerate(
        params, jcfg, jnp.asarray(prompt), max_new=8, max_s=32,
        batch_inputs=None if inputs is None else _jbatch(inputs)))
    got = decode.generate(model, cfg, prompt, max_new=8, max_s=32,
                          batch_inputs=inputs)
    assert got.shape == (2, 28) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_encdec_decode_tracks_the_teacher_forced_forward(smoke_models):
    """Port-only, as tests/test_models.py's: token-by-token decode against
    ``forward_train`` over the same tokens, up to the bf16 storage of the
    self and cross K/V (2e-2)."""
    _, _, cfg, model = smoke_models["whisper_tiny"]
    batch = _batch(cfg, _tokens(cfg, 1, 12, 16), 17)
    full, _ = api.forward_train(model, cfg, batch)
    caches = api.init_caches(model, cfg, 1, 16,
                             batch_inputs={"frames": batch["frames"]})
    outs = []
    for i in range(12):
        step, caches = api.decode_step(model, cfg,
                                       batch["tokens"][:, i:i + 1], caches)
        outs.append(step[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_encdec_consults_the_plan_cache_once_per_self_kv_cache(
        smoke_models, monkeypatch):
    """One consult when init_caches sets up the self caches (here twice:
    ours and generate's); cross-attention is never planned, and a step
    makes no consult."""
    consults = []
    monkeypatch.setattr(attention, "planned_pv_right_first",
                        lambda *a, **k: consults.append(a) or True)
    _, _, cfg, model = smoke_models["whisper_tiny"]
    frames = _inputs(cfg, 1, 18)
    caches = api.init_caches(model, cfg, 1, 24, batch_inputs=frames)
    assert caches.self_kv.right_first is True
    assert consults == [(1, 24, cfg.head_dim, cfg.d_model)]
    decode.generate(model, cfg, [[3, 4]], max_new=3, max_s=24,
                    batch_inputs=frames)
    assert len(consults) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_warmup_shapes_match_reference(monkeypatch, arch):
    """The self-attention tail is planned at ``max_s``; cross-attention
    is not planned."""
    from repro.serve import decode as jdecode
    from repro.serve.plan_cache import reset_default_plan_service as jreset
    from repro_torch.serve.plan_cache import reset_default_plan_service
    monkeypatch.setenv("REPRO_SERVE_DISCRIMINANT", "flops")
    cfg, jcfg = configs.get_smoke(arch), jget_smoke(arch)
    jreset()
    reset_default_plan_service()
    try:
        want = jdecode.plan_warmup(jcfg, max_s=48)
        assert decode.plan_warmup(cfg, 48, device="cpu") == want
    finally:
        jreset()
        reset_default_plan_service()
    assert [f for f, _ in want].count("decattn") == 1


# ---------------------------------------------------- weights and counts ---

def test_convert_carries_an_encdec_tree_and_raises_on_encoder_leaves(
        smoke_models):
    """The encoder stack unstacks by ``encoder_layers`` and the decoder's
    by ``n_layers``; a missing, unused or mis-shaped encoder leaf raises,
    as does an encoder cut to the wrong depth."""
    jcfg, params, cfg, model = smoke_models["whisper_tiny"]
    tree = jax.tree.map(np.asarray, params)
    np.testing.assert_array_equal(model.encoder[1].mlp.up.w.numpy(),
                                  tree["encoder"]["mlp"]["up"]["w"][1])
    np.testing.assert_array_equal(model.decoder[1].cross.wk.w.numpy(),
                                  tree["decoder"]["cross"]["wk"]["w"][1])
    np.testing.assert_array_equal(model.enc_norm.g.numpy(),
                                  tree["enc_norm"]["g"])
    enc = dict(tree["encoder"])
    del enc["pre_mlp_norm"]
    with pytest.raises(ValueError,
                       match=r"missing \['encoder.0.pre_mlp_norm.g'"):
        convert.from_reference_params(dict(tree, encoder=enc), cfg,
                                      device="cpu")
    extra = dict(tree["encoder"], cross=tree["decoder"]["cross"])
    with pytest.raises(ValueError, match=r"unused \['encoder.0.cross.wk.w'"):
        convert.from_reference_params(dict(tree, encoder=extra), cfg,
                                      device="cpu")
    bad = dict(tree["encoder"], mlp=dict(tree["encoder"]["mlp"], up={
        "w": np.zeros((cfg.encoder_layers, cfg.d_model, cfg.d_ff + 1))}))
    with pytest.raises(ValueError,
                       match="encoder.0.mlp.up.w: reference shape"):
        convert.from_reference_params(dict(tree, encoder=bad), cfg,
                                      device="cpu")
    cut = jax.tree.map(lambda a: a[:1], tree["encoder"])
    with pytest.raises(ValueError, match="is not the 2 layers"):
        convert.from_reference_params(dict(tree, encoder=cut), cfg,
                                      device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_models_count_their_parameters(arch, smoke):
    """A model built on ``meta`` holds the config's analytic count plus
    the norm gains and the vocabulary's pad rows: whisper's encoder
    blocks with their 2-matrix MLP and the decoder's cross-attention,
    InternVL2's GLU decoder and untied head."""
    cfg = (configs.get_smoke if smoke else configs.get)(arch)
    model = api.family_module(cfg).init(cfg, None, device="meta")
    n = sum(p.numel() for p in model.parameters())
    norms = sum(p.numel() for name, p in model.named_parameters()
                if name.endswith(".g"))
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (
        1 if cfg.tied_embeddings else 2)
    assert n == cfg.param_count() + norms + pad
    if not smoke and arch == "internvl2_76b":
        # 80 layers of 855.64 M and 2.10 B of embedding and head.
        assert cfg.param_count() == 80 * 855_638_016 + 2 * 128256 * 8192


def test_encdec_belongs_to_its_own_module():
    cfg = configs.get_smoke("whisper_tiny")
    assert api.family_module(cfg) is encdec
    assert api.family_module(configs.get_smoke("internvl2_76b")) \
        is transformer
    with pytest.raises(ValueError, match="assembled by models.encdec"):
        transformer.init(cfg, None, device="meta")
    with pytest.raises(ValueError, match="takes the encdec family"):
        encdec.init(configs.get_smoke("yi_9b"), None, device="meta")
