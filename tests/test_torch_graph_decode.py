"""The port's graph-safe decode step against the JAX package's, on the CPU.

``serve.decode.generate`` captures the serve step in a CUDA graph on the
card and replays it for every token. A replay re-runs the captured
kernels on the same buffers, so the step must (1) read nothing on the
host and build no tensor from host data (either would break the capture
or freeze a value into the graph) and (2) advance all its state in
place. These tests hold both for every architecture's smoke config:

* (1) one decode step under a ``TorchDispatchMode`` that raises on
  ``aten._local_scalar_dense`` (a host read: ``int(t)``, ``t.item()``,
  ``bool(t)``), ``aten.nonzero`` (a data-dependent shape) and
  ``aten.lift_fresh`` / ``lift_fresh_copy`` (``torch.tensor`` of host
  data);
* (2) the serve step driven as a replay drives it: one state object,
  never reassigned, the prompt tokens copied into its ``last_tokens``
  and each step's next tokens copied there, the caches checked to be the
  very tensors it started with. The tokens must equal the reference's
  ``repro.serve.decode.generate`` exactly (both under
  ``REPRO_SERVE_PLANNER=0``), as tests/test_torch_serve.py asks of
  ``generate``.

The capture itself needs the card: tests/test_torch_gpu.py holds the
captured step against the eager one there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke as jget_smoke
from repro.models import api as japi
from repro.serve.decode import generate as jgenerate
from repro_torch import configs
from repro_torch.models import api, convert
from repro_torch.serve import decode

ARCHS = tuple(configs.ARCH_IDS)
#: The ops a graph-safe step never dispatches.
HOST_OPS = {torch.ops.aten._local_scalar_dense.default,
            torch.ops.aten.nonzero.default,
            torch.ops.aten.lift_fresh.default,
            torch.ops.aten.lift_fresh_copy.default}


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _frames(cfg, b, seed):
    """The encdec family's stub frames (B, S_enc, d); None elsewhere."""
    if cfg.family != "encdec":
        return None
    return {"frames": np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


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


class NoHostData(TorchDispatchMode):
    """Raises on the first op of :data:`HOST_OPS`; counts the others."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_OPS:
            raise AssertionError(f"the step dispatched {func}")
        self.calls += 1
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_host_reads_and_host_data():
    t = torch.arange(4)
    for bad in (lambda: int(t[1]), lambda: t.nonzero(),
                lambda: torch.tensor([1.0]) + t,
                lambda: t[torch.tensor(1)]):
        with pytest.raises(AssertionError, match="dispatched"):
            with NoHostData():
                bad()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_on_the_host(smoke_models, arch):
    """Two steps from fresh caches, the second past a prompt token, each
    under the mode; the tokens are a device (here CPU) tensor, as a
    replay feeds them, and the lengths advance on the device."""
    _, _, cfg, model = smoke_models[arch]
    caches = api.init_caches(model, cfg, 2, 8,
                             batch_inputs=_frames(cfg, 2, 1))
    tokens = torch.from_numpy(_tokens(cfg, 2, 2, 2)).long()
    lengths = [t for t in decode._leaves(caches) if t.dim() == 0]
    assert lengths and all(t.dtype == torch.int64 for t in lengths)
    for i in range(2):
        with NoHostData() as mode:
            logits, out = api.decode_step(model, cfg, tokens[:, i:i + 1],
                                          caches)
        assert out is caches and mode.calls > 0
        assert logits.shape == (2, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        assert [int(t) for t in lengths] == [i + 1] * len(lengths)


def _replayed_generate(model, cfg, prompt, max_new, max_s, inputs):
    """``generate`` written out as a captured graph runs it: one state,
    prompt tokens and next tokens copied into its ``last_tokens``; every
    cache tensor stays the object (and the storage) it was."""
    prompt = torch.from_numpy(prompt).long()
    b, s0 = prompt.shape
    caches = api.init_caches(model, cfg, b, max_s, batch_inputs=inputs)
    state = decode.ServeState(caches=caches,
                              last_tokens=prompt[:, :1].clone(),
                              rng=torch.Generator().manual_seed(0))
    leaves = decode._leaves(caches)
    ptrs = [t.data_ptr() for t in leaves]
    step = decode.make_serve_step(cfg)
    out = [prompt]
    for i in range(s0 - 1 + max_new):
        new, nxt = step(state, model)
        assert new.caches is caches and new.logits.shape == (
            b, cfg.padded_vocab)
        state.last_tokens.copy_(nxt)
        if i < s0 - 1:
            state.last_tokens.copy_(prompt[:, i + 1:i + 2])
        else:
            out.append(nxt.clone())
    assert [t.data_ptr() for t in decode._leaves(caches)] == ptrs
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_replayed_serve_step_is_token_identical_to_reference(
        smoke_models, monkeypatch, arch):
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    jcfg, params, cfg, model = smoke_models[arch]
    prompt = _tokens(cfg, 2, 10, 3)
    inputs = _frames(cfg, 2, 4)
    want = np.asarray(jgenerate(
        params, jcfg, jnp.asarray(prompt), max_new=6, max_s=16,
        batch_inputs=None if inputs is None else
        {k: jnp.asarray(v) for k, v in inputs.items()}))
    got = _replayed_generate(model, cfg, prompt, 6, 16, inputs)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- the helpers ---

def test_sample_is_multinomials_draw():
    """``decode.sample`` draws what ``torch.multinomial`` draws from the
    same generator state, and leaves the generator where it leaves it."""
    for seed in range(4):
        logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(
            seed + 100)) * 3
        g1, g2 = (torch.Generator().manual_seed(seed) for _ in range(2))
        want = torch.multinomial(torch.softmax(logits / 0.7, -1), 1,
                                 generator=g1)[:, 0]
        assert torch.equal(decode.sample(logits, 0.7, g2), want)
        assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("arch,ok", [("yi_9b", 7), ("whisper_tiny", 7),
                                     ("mamba2_370m", 100),
                                     ("zamba2_1p2b", 100)])
def test_capacity_check(arch, ok):
    """A prompt of 3 and 5 new tokens write positions 0..6: 7 fit, 6 do
    not. The SSM family has no KV cache and the hybrid's ring wraps."""
    cfg = configs.get_smoke(arch)
    decode.check_capacity(cfg, 3, 5, 7)
    if ok == 7:
        with pytest.raises(ValueError, match="KV cache full"):
            decode.check_capacity(cfg, 3, 5, 6)
    else:
        decode.check_capacity(cfg, 3, 5, 1)


def test_capture_needs_the_card(smoke_models):
    _, _, cfg, model = smoke_models["yi_9b"]
    state = decode.ServeState(api.init_caches(model, cfg, 1, 4),
                              torch.zeros((1, 1), dtype=torch.long), None)
    with pytest.raises(ValueError, match="CUDA"):
        decode.compile_serve_step(decode.make_serve_step(cfg), state, model)
    with pytest.raises(ValueError, match="CUDA"):
        decode.generate(model, cfg, [[1, 2]], max_new=2, capture=True)
