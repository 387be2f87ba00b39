"""The port's optimizers against the JAX package's, on the CPU.

Same seeded numpy trees and gradients go through both packages. Float32
results compare at rtol 1e-6 and atol 5e-8 (the same float32 operations,
a few in another order: a parameter near 0 keeps the rounding of its
updates, which reach lr 0.03 × O(1); the largest such difference
measured was 2.05e-8). Newton–Schulz runs in bf16 in both, where the two
libraries round matrix products and elementwise sums differently and the
quintic iteration amplifies it: over seeds 0–3 and shapes (64, 128),
(96, 48) and (32, 200) the port's result differs from the reference's by
at most 0.089 (gram, gram_gemm) and 0.078 (right) of its Frobenius norm
(the port's is the closer of the two to a float64 iteration), so
``NS_TOL`` is 3× that, 0.27; a matrix leaf's Muon update compares at
``NS_TOL`` of its size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.perfmodel import AnalyticalTPUProfile as JTPUProfile
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import muon as jmuon
from repro.optim import schedule as jschedule
from repro_torch.core.perfmodel import (AnalyticalHopperProfile,
                                        AnalyticalTPUProfile)
from repro_torch.optim import adamw, grad_compress, leaves, muon, schedule

TOL = dict(rtol=1e-6, atol=5e-8)
NS_TOL = 0.27


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_tree(rng, shapes):
    """A reference tree of seeded float32 leaves: ``blocks`` holds a
    stack of 10 layers (one vector and one matrix per layer)."""
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}


SHAPES = {"w": (24, 40), "v": (40,), "small": (4, 32),
          "blocks.g": (10, 16), "blocks.w": (10, 12, 12)}
SHAPES_DEPTH = range(10)


def _port_tree(tree):
    """The reference tree under the port's names: a stack's leaves split
    into ``blocks.<i>.<leaf>``."""
    out = {}
    for name, arr in tree.items():
        if name.startswith("blocks."):
            leaf = name[len("blocks."):]
            for i in range(len(SHAPES_DEPTH)):
                out[f"blocks.{i}.{leaf}"] = None if arr is None \
                    else torch.tensor(arr[i])
        else:
            out[name] = None if arr is None else torch.tensor(arr)
    return out


def _jax_tree(tree):
    """The reference's nesting: ``{"blocks": {...}, ...}``."""
    out = {k: jnp.asarray(v) for k, v in tree.items()
           if not k.startswith("blocks.")}
    out["blocks"] = {k[len("blocks."):]: jnp.asarray(v)
                     for k, v in tree.items() if k.startswith("blocks.")}
    return out


def _flat_jax(tree):
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    flat.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: None if v is None else _np(v) for k, v in flat.items()}


def _assert_port_matches(port, ref, tol=TOL):
    want = _port_tree(ref)
    assert set(port) == set(want)
    for name in want:
        np.testing.assert_allclose(port[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


# -------------------------------------------------------------- leaves ---

def test_reference_leaves_of_port_names():
    p = torch.zeros(16)
    assert leaves.reference_name("blocks.3.mixer.norm.g") == \
        "blocks.mixer.norm.g"
    assert leaves.reference_name("shared.attn.wq.w") == "shared.attn.wq.w"
    assert leaves.reference_ndim("decoder.0.mlp.up.w", torch.zeros(2, 2)) == 3
    assert leaves.reference_ndim("final_norm.g", p) == 1
    assert leaves.reference_shape("encoder.2.attn.wq.w", p, 4) == (4, 16)
    assert leaves.group(["blocks.10.g", "blocks.2.g", "embed.w"]) == {
        "blocks.g": ["blocks.2.g", "blocks.10.g"], "embed.w": ["embed.w"]}


# ----------------------------------------------------------- schedules ---

@pytest.mark.parametrize("name", sorted(schedule.SCHEDULES))
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedules_match_reference(name, warmup):
    total = 50
    for step in range(total + 1):
        got = schedule.SCHEDULES[name](step, 3e-4, warmup, total)
        want = jschedule.SCHEDULES[name](jnp.asarray(step), 3e-4, warmup,
                                         total)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


# --------------------------------------------------------------- AdamW ---

@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_three_steps_match_reference(grad_clip):
    """Gradients of norm ~30 are clipped to 1 (or not); weight decay
    applies to the matrices and to the stacked layer vectors
    (``blocks.g`` is (10, 16) in the reference), not to ``v``."""
    rng = np.random.default_rng(0)
    ref = _ref_tree(rng, SHAPES)
    jp = _jax_tree(ref)
    params = _port_tree(ref)
    jstate, state = jadamw.init(jp), adamw.init(params)
    for step in range(3):
        g = _ref_tree(rng, SHAPES)
        lr = 1e-2 * (step + 1)
        jp, jstate = jadamw.update(_jax_tree(g), jstate, jp, jnp.asarray(lr),
                                   grad_clip=grad_clip)
        state = adamw.update(_port_tree(g), state, params, lr,
                             grad_clip=grad_clip)
    assert int(state.step) == int(jstate.step) == 3
    _assert_port_matches(params, _flat_jax(jp))
    _assert_port_matches(state.mu, _flat_jax(jstate.mu))
    _assert_port_matches(state.nu, _flat_jax(jstate.nu))


def test_adamw_decays_by_reference_rank():
    params = _port_tree(_ref_tree(np.random.default_rng(1), SHAPES))
    before = {n: p.clone() for n, p in params.items()}
    zero = {n: torch.zeros_like(p) for n, p in params.items()}
    adamw.update(zero, adamw.init(params), params, 0.5, weight_decay=0.1)
    for n, p in params.items():
        decayed = not torch.equal(p, before[n])
        assert decayed == (n != "v"), n


def test_adamw_converges_on_quadratic():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    a = torch.tensor(a @ a.T / 16 + np.eye(16, dtype=np.float32))
    target = torch.tensor(rng.standard_normal((16, 16)).astype(np.float32))
    params = {"w": torch.zeros(16, 16)}

    def loss():
        r = params["w"] - target
        return torch.trace(r.T @ a @ r)

    state, l0 = adamw.init(params), float(loss())
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        r = w - target
        (g,) = torch.autograd.grad(torch.trace(r.T @ a @ r), w)
        state = adamw.update({"w": g}, state, params, 0.05, weight_decay=0.0)
    assert float(loss()) < 0.01 * l0


# ---------------------------------------------------------------- Muon ---

@pytest.mark.parametrize("mode", ["gram", "gram_gemm", "right"])
@pytest.mark.parametrize("shape", [(64, 128), (96, 48)])
def test_newton_schulz_matches_reference(mode, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = muon.newton_schulz(torch.from_numpy(x), mode=mode)
    want = jmuon.newton_schulz(jnp.asarray(x), mode=mode)
    assert got.shape == shape and got.dtype == torch.float32
    want = _np(want)
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= NS_TOL, err
    sv = np.linalg.svd(got.numpy(), compute_uv=False)
    assert np.all(sv < 1.6) and np.all(sv > 0.4)


@pytest.mark.parametrize("discriminant", ["perfmodel", "flops"])
def test_plan_ns_mode_tpu_profile_picks_match_reference(discriminant):
    dims = (8, 48, 128, 512, 1024, 2048, 4384, 50304)
    for m in dims:
        for k in dims:
            got = muon.plan_ns_mode(m, k, discriminant,
                                    profile=AnalyticalTPUProfile())
            want = jmuon.plan_ns_mode(m, k, discriminant,
                                      profile=JTPUProfile())
            assert got == want, (m, k)


def test_plan_ns_mode_defaults_to_the_hopper_profile():
    for m, k in [(48, 1024), (1024, 50304), (128, 8192), (512, 512)]:
        assert muon.plan_ns_mode(m, k) == muon.plan_ns_mode(
            m, k, profile=AnalyticalHopperProfile())
    assert muon.plan_ns_mode(128, 8192, "flops") in ("gram", "gram_gemm")


@pytest.mark.parametrize("mode", ["gram", "gram_gemm", "right"])
def test_ns_algorithm_calls_flops_match_reference(mode):
    for m, k in [(128, 8192), (1024, 4384), (48, 2048), (300, 200)]:
        got = [(c.kind, c.dims, c.flops)
               for c in muon.ns_algorithm_calls(mode, m, k)]
        want = [(c.kind, c.dims, c.flops)
                for c in jmuon.ns_algorithm_calls(mode, m, k)]
        assert got == want
    with pytest.raises(ValueError):
        muon.ns_algorithm_calls("left", 4, 4)


def test_muon_partition_follows_the_reference_leaves():
    """``w`` (24, 40) and the stacked vectors ``blocks.g`` (10, 16) are
    matrices; ``v`` (a vector), ``small`` (4 rows) and the stacked
    matrices ``blocks.w`` (3-D in the reference) take AdamW."""
    rng = np.random.default_rng(3)
    ref = _ref_tree(rng, SHAPES)
    jlabels = jmuon.partition(_jax_tree(ref))
    labels = muon.partition(_port_tree(ref))
    for name, value in labels.items():
        leaf = name if not name.startswith("blocks.") else \
            "blocks." + name.split(".", 2)[2]
        want = jlabels[leaf] if not leaf.startswith("blocks.") \
            else jlabels["blocks"][leaf[len("blocks."):]]
        assert value == want, name
    assert sorted(n for n, v in labels.items() if v)[:2] == \
        ["blocks.0.g", "blocks.1.g"]
    state = muon.init(_port_tree(ref))
    assert state.momentum["v"] is None and state.momentum["w"] is not None


@pytest.mark.parametrize("steps", [1, 2])
def test_muon_update_matches_reference(steps):
    """AdamW leaves and both moments at ``TOL``; each Muon matrix's
    update at ``NS_TOL`` of its size (bf16 Newton–Schulz)."""
    rng = np.random.default_rng(4)
    ref = _ref_tree(rng, SHAPES)
    jp = _jax_tree(ref)
    params = _port_tree(ref)
    before = {n: p.clone() for n, p in params.items()}
    jstate, state = jmuon.init(jp), muon.init(params)
    for step in range(steps):
        g = _ref_tree(rng, SHAPES)
        jp, jstate = jmuon.update(_jax_tree(g), jstate, jp, jnp.asarray(0.02),
                                  weight_decay=0.1)
        state = muon.update(_port_tree(g), state, params, 0.02,
                            weight_decay=0.1)
    assert int(state.step) == int(state.adamw.step) == steps
    want = _port_tree(_flat_jax(jp))
    labels = muon.partition(params)
    for name, p in params.items():
        if labels[name]:
            err = float((p - want[name]).norm()
                        / (want[name] - before[name]).norm())
            assert err <= NS_TOL, (name, err)
        else:
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       err_msg=name, **TOL)
    _assert_port_matches(state.adamw.mu, _flat_jax(jstate.adamw.mu))
    _assert_port_matches(state.adamw.nu, _flat_jax(jstate.adamw.nu))
    if steps == 1:   # the momentum is the first gradient until NS feeds back
        mom = {n: m for n, m in state.momentum.items() if m is not None}
        want = _port_tree(_flat_jax(jstate.momentum))
        for name, m in mom.items():
            np.testing.assert_allclose(m.numpy(), want[name].numpy(), **TOL)


def test_muon_converges_on_quadratic():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    a = torch.tensor(a @ a.T / 16 + np.eye(16, dtype=np.float32))
    target = torch.tensor(rng.standard_normal((16, 16)).astype(np.float32))
    params = {"w": torch.zeros(16, 16)}

    def loss_and_grad():
        w = params["w"].clone().requires_grad_(True)
        r = w - target
        loss = torch.trace(r.T @ a @ r)
        return float(loss.detach()), torch.autograd.grad(loss, w)[0]

    state, (l0, _) = muon.init(params), loss_and_grad()
    for _ in range(200):
        _, g = loss_and_grad()
        state = muon.update({"w": g}, state, params, 0.05)
    assert loss_and_grad()[0] < 0.05 * l0


# --------------------------------------------------------- compression ---

def test_grad_compress_matches_reference():
    """Codes identical, scales within 1e-7, residuals at ``TOL``, over two
    rounds (the second carries the first's residual)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (300,), "b": (17, 31), "c": (256,)}
    state = jstate = None
    for _ in range(2):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        state = state or grad_compress.init_state(tg)
        jstate = jstate or jgc.init_state(jg)
        comp, state = grad_compress.compress(tg, state)
        jcomp, jstate = jgc.compress(jg, jstate)
        for k in shapes:
            assert comp[k].shape == jcomp[k].shape
            np.testing.assert_array_equal(comp[k].q.numpy(),
                                          np.asarray(jcomp[k].q))
            np.testing.assert_allclose(comp[k].scale.numpy(),
                                       np.asarray(jcomp[k].scale),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(state.residual[k].numpy(),
                                       np.asarray(jstate.residual[k]),
                                       **TOL)
        deq, jdeq = grad_compress.decompress(comp), jgc.decompress(jcomp)
        for k in shapes:
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(jdeq[k]),
                                       **TOL)


def test_grad_compress_error_feedback_tracks_the_sum():
    rng = np.random.default_rng(1)
    true_sum = torch.zeros(64)
    deq_sum = torch.zeros(64)
    state = grad_compress.init_state({"w": true_sum})
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.1)
        true_sum += g
        comp, state = grad_compress.compress({"w": g}, state)
        deq_sum += grad_compress.decompress(comp)["w"]
    assert float((deq_sum - true_sum).abs().max()) < 0.02
