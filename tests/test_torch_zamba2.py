"""The port's published Zamba2 shared block (``shared_block="published"``)
against a plain float32 reference (``tests/zamba2_reference.py``) on the
CPU, at a smoke size: 5 Mamba2 layers, d_model 64, the shared block
applied before layers 2 and 4 (attention from 128 wide as 4 heads of 32,
adapters of rank 8), seeded random weights.

Both sides compute in float32 on the CPU. They differ only by the order
of float32 sums (the port's SSD in chunks or its quadratic form, the
reference's whole-sequence form; dense attention on both sides below
2,048 positions, the port's blockwise scan from 2,048 on). A tensor
compares by its largest difference as a share of its largest entry: the
logits within ``REL_LOGITS`` = 2e-5 (the port reads ~1.3e-6), a
gradient within ``REL_GRAD`` = 5e-5 (the worst leaf reads ~7.5e-6). The
tanh GELU moves the logits by 2.5e-4 to 5.9e-4 and the worst gradient by
9e-4 to 8e-3, a head_dim^-½ logit scale the logits by 0.26 to 0.45: each
fails by more than ten times (``test_the_tolerance_tells_...``).

Also here: the default (reference) block of the zamba2 preset still
computes the JAX package's loss and gradients.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import zamba2_reference as ref
from repro.configs import get_smoke as jget_smoke
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api, convert, hybrid
from repro_torch.serve import decode
from repro_torch.train import train_step as ts

#: Largest difference allowed, as a share of the largest entry (module
#: docstring).
REL_LOGITS, REL_GRAD = 2e-5, 5e-5


def published(**over):
    """The published preset's smoke config: 2 applications (layers 2 and
    4), 1 memory block, adapters on q, k, v and gate_up."""
    return dataclasses.replace(
        configs.get_smoke("zamba2_1p2b_published"), **over)


#: The catalog's Zamba2-7B switches at smoke size: two memory blocks taken
#: in turn, adapters on the MLP only, hybrid layers given one by one.
SEVEN_B = dict(num_mem_blocks=2, attn_adapters=False, hybrid_layers=[1, 3, 4])


def weights(cfg, seed=0):
    """The port's random weights of ``cfg``, the gains, conv biases and
    adapters' B moved off their initial values so that each leaf
    matters."""
    model = api.init(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".g") or name.endswith("conv_b"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith(".b.w"):
                p.mul_(10.0)
    return model, {n: p.detach().clone() for n, p in
                   model.named_parameters()}


def tokens(cfg, b, s, seed=3):
    return torch.randint(0, cfg.vocab, (b, s + 1),
                         generator=torch.Generator().manual_seed(seed))


def close(got, want, rel=REL_LOGITS):
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def assert_close(got, want, what="", rel=REL_LOGITS):
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= rel, (what, err)


def reference_grads(cfg, w, tok, **shared):
    p = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    logits = ref.forward(p, ref.spec(cfg), tok[:, :-1], **shared)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tok[:, 1:].reshape(-1))
    names = list(p)
    grads = torch.autograd.grad(loss, [p[n] for n in names],
                                allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p[n]) if g is None else g
                           for n, g in zip(names, grads)}


def port_grads(cfg, w, tok):
    state = ts.make_train_state(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for n, t in w.items():
            state.params[n].copy_(t)
    metrics, grads = ts._grads(cfg, state, {"tokens": tok[:, :-1],
                                            "labels": tok[:, 1:]}, 1,
                               torch.float32)
    return metrics["loss"], grads


@pytest.mark.parametrize("over", [{}, SEVEN_B], ids=["1p2b", "7b_switches"])
@pytest.mark.parametrize("seq", [32, 2048])
def test_training_logits_match_the_reference(over, seq):
    """2,048 positions take the port's blockwise attention, the cell's
    route."""
    cfg = published(**over)
    model, w = weights(cfg)
    tok = tokens(cfg, 1, seq)[:, :-1]
    got, aux = api.forward_train(model, cfg, {"tokens": tok})
    want = ref.forward(w, ref.spec(cfg), tok)
    assert got.shape == want.shape == (1, seq, cfg.vocab)
    assert_close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("over", [{}, SEVEN_B], ids=["1p2b", "7b_switches"])
def test_loss_and_every_gradient_match_the_reference(over):
    cfg = published(**over)
    _, w = weights(cfg, seed=4)
    tok = tokens(cfg, 2, 32, seed=5)
    loss, grads = port_grads(cfg, w, tok)
    want_loss, want = reference_grads(cfg, w, tok)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert set(grads) == set(want) == set(w)
    for name in w:
        assert float(want[name].abs().max()) > 0, name
        assert_close(grads[name], want[name], name, REL_GRAD)


def test_the_shared_weights_sum_their_applications_gradients():
    """Each application's share of the memory block's gradient (the
    reference with the block's weights detached in the others) adds up to
    the port's gradient; an adapter's or a ``linear``'s, which only its
    own application reads, is the same in every split."""
    cfg = published()
    _, w = weights(cfg, seed=6)
    tok = tokens(cfg, 2, 32, seed=7)
    _, grads = port_grads(cfg, w, tok)
    shares = [reference_grads(cfg, w, tok, mem_grad_from={a})[1]
              for a in range(hybrid.n_shared_applications(cfg))]
    mem = [n for n in w if n.startswith("mem_blocks.")]
    assert mem
    for name in mem:
        parts = [s[name] for s in shares]
        assert all(float(p.abs().max()) > 0 for p in parts), name
        assert_close(grads[name], sum(parts), name, REL_GRAD)
        assert not close(grads[name], parts[0], REL_GRAD)
    for a in range(2):
        for name in (n for n in w if n.startswith(f"applications.{a}.")):
            for share in shares:
                assert_close(grads[name], share[name], name, REL_GRAD)


@pytest.mark.parametrize("over", [{}, SEVEN_B], ids=["1p2b", "7b_switches"])
def test_decode_through_the_cache_matches_the_full_forward(over):
    """Each token's decode logits, from float32 caches, against the
    reference's full forward over the sequence."""
    cfg = published(**over)
    model, w = weights(cfg, seed=8)
    tok = tokens(cfg, 2, 24, seed=9)[:, :-1]
    caches = api.init_caches(model, cfg, 2, 32, dtype=torch.float32)
    assert caches.shared_kv.k.shape == (
        hybrid.n_shared_applications(cfg), 2, 32, cfg.n_kv_heads,
        cfg.head_dim)
    steps = []
    for i in range(tok.shape[1]):
        logits, caches = api.decode_step(model, cfg, tok[:, i:i + 1],
                                         caches)
        steps.append(logits)
    assert int(caches.shared_kv.length) == int(caches.ssm.length) == 24
    want = ref.forward(w, ref.spec(cfg), tok)
    assert_close(torch.cat(steps, dim=1), want)


@pytest.mark.parametrize("over", [{}, SEVEN_B], ids=["1p2b", "7b_switches"])
@pytest.mark.parametrize("mutant", [dict(gelu="tanh"),
                                    dict(scale=32 ** -0.5)],
                         ids=["tanh_gelu", "head_dim_scale"])
def test_the_tolerance_tells_the_published_equations_apart(mutant, over):
    """The tanh GELU or a head_dim^-½ scale in the reference moves the
    logits, and the gradients, by more than ten times their tolerance:
    the comparisons above would catch a port that computed either."""
    cfg = published(**over)
    model, w = weights(cfg, seed=4)
    tok = tokens(cfg, 2, 32, seed=5)
    got, _ = api.forward_train(model, cfg, {"tokens": tok[:, :-1]})
    c = ref.spec(cfg)
    assert close(got, ref.forward(w, c, tok[:, :-1]))
    assert not close(got, ref.forward(w, c, tok[:, :-1], **mutant),
                     10 * REL_LOGITS)
    _, grads = port_grads(cfg, w, tok)
    _, want = reference_grads(cfg, w, tok, **mutant)
    assert any(not close(grads[n], want[n], 10 * REL_GRAD) for n in w)


def test_parameters_are_counted():
    """Every parameter is the analytic count plus what it leaves out
    (norm gains, each Mamba2 layer's conv, conv bias and per-head
    vectors), at smoke size and at Zamba2-1.2B's published widths."""
    full = configs.get("zamba2_1p2b_published")
    for cfg in (published(), published(**SEVEN_B), full):
        device = "meta" if cfg is full else "cpu"
        model = hybrid.init(cfg, None if cfg is full else
                            torch.Generator().manual_seed(0), device=device)
        n = sum(p.numel() for p in model.parameters())
        norms = sum(p.numel() for name, p in model.named_parameters()
                    if name.endswith(".g"))
        s = cfg.ssm
        conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
        extra = cfg.n_layers * ((s.conv_kernel + 1) * conv_ch
                                + 3 * s.n_heads)
        assert n == cfg.param_count() + norms + extra
    assert n == 1_205_078_912
    assert full.hybrid_layer_ids == [6, 12, 18, 24, 30, 36]
    assert full.shared_attn_cfg.d_model == 4096
    assert full.shared_attn_cfg.query_pre_scale == 0.125


def test_the_published_layout_checks_its_settings():
    for bad in (dict(adapter_rank=0), dict(num_mem_blocks=0),
                dict(hybrid_layers=[2, 5])):
        with pytest.raises(ValueError, match="published shared block"):
            api.init(published(**bad), device="cpu")
    with pytest.raises(ValueError, match="shared_block"):
        api.init(published(shared_block="other"), device="cpu")
    # a list set by dotted path is kept as a tuple, and the config hashes
    assert hash(published(hybrid_layers=[1, 3])) == \
        hash(published(hybrid_layers=(1, 3)))


def test_only_the_published_cache_refuses_to_overrun():
    """The published block's KV cache holds every position; the
    reference block's is a ring buffer."""
    with pytest.raises(ValueError, match="KV cache full"):
        decode.check_capacity(published(), 20, 20, 32)
    decode.check_capacity(published(), 20, 13, 32)
    decode.check_capacity(configs.get_smoke("zamba2_1p2b"), 20, 20, 32)


def test_the_default_preset_still_computes_the_reference_block():
    """The zamba2 smoke preset, with the new fields at their defaults,
    has the JAX package's loss and every gradient of it."""
    jcfg = jget_smoke("zamba2_1p2b")
    params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke("zamba2_1p2b")
    assert cfg.shared_block == "reference"
    as_np = jax.tree.map(np.asarray, params)
    model = convert.from_reference_params(as_np, cfg, device="cpu")
    tok = tokens(cfg, 2, 64, seed=11).numpy().astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, batch), has_aux=True)(params)
    want = dict(convert.from_reference_params(
        jax.tree.map(np.asarray, jgrads), cfg,
        device="cpu").named_parameters())
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = api.loss_fn(model, cfg, {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert any(n.startswith("shared.") for n in names)
    for name, g in zip(names, grads):
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= 1e-3 * scale + 1e-7, \
            name
