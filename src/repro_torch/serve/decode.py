"""Serving steps: single-token decode (greedy/temperature) and generation.

Counterpart of the reference's ``serve/decode.py``. ``serve_step`` is one
new token for the whole batch against the caches (KV, SSM, the hybrid
family's SSM caches and shared ring-buffer KV, or the encdec family's
self KV beside its cross K/V); ``generate`` feeds a prompt token by
token (teacher-forced; the only prefill the hybrid and encdec families
have) and then decodes. The decode attention tail's association is a
consult of the serving plan cache, made once when the KV cache is set up
(``transformer.plan_decode``, with the cache's capacity; caches without
attention make none), so :func:`plan_warmup` plans a model's decode
shapes before that: the consult is then a cache hit, and a step makes
none. Sampling draws from an explicit ``torch.Generator`` seeded by
``seed`` (its numbers differ from ``jax.random``'s; greedy decoding does
not sample).

The compiled step: the reference jits its serve step, so a token is one
compiled program. Here :func:`compile_serve_step` captures the step in a
``torch.cuda.CUDAGraph`` and a token is one replay. Every family's
decode step is graph-safe for that: cache lengths are 0-d tensors on the
device, every position is read under a mask, nothing is read on the host
or built from host data, and all state (caches, lengths, the generator)
advances in place. :func:`generate` captures on CUDA once per request;
``capture=False`` asks for the eager step instead, and on the CPU the
same in-place step runs eagerly. :func:`compile_serve_step` captures a
sharded step (DTensor parameters, caches laid out by
``launch.specs.shard_caches``) as it is: the graph holds the kernels
DTensor's dispatch launched on the local shards and any collective it
issued, so a replay skips DTensor's Python altogether.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import api
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import ModelConfig
from repro_torch.runtime.supervisor import StragglerMonitor
from repro_torch.serve.plan_cache import default_plan_service, planner_enabled
from repro_torch.sharding.context import whole_within


def plan_warmup(cfg: ModelConfig, max_s: int,
                device="cuda") -> List[Tuple[str, Tuple]]:
    """Pre-plan the zoo families a decode step of ``cfg`` consults, in the
    default plan service of ``device``: the reference's shapes, the
    attention tail at the cache's ``max_s`` and the attention output
    projection only where the model has attention heads (none for the
    SSM family), the MLP where it has a ``d_ff``, and the logits.

    Returns the (family, dims) pairs warmed. No-op (empty list) when the
    consult is disabled via ``REPRO_SERVE_PLANNER=0``.
    """
    if not planner_enabled():
        return []
    shapes: List[Tuple[str, Tuple]] = []
    if cfg.n_heads and cfg.head_dim:
        shapes.append(("decattn", (1, max_s, cfg.head_dim, cfg.d_model)))
        shapes.append(("decproj", (1, cfg.d_model,
                                   cfg.n_heads * cfg.head_dim)))
    if cfg.d_ff:
        shapes.append(("decmlp", (1, cfg.d_model, cfg.d_ff)))
    shapes.append(("decproj", (1, cfg.d_model, cfg.vocab)))  # logits
    default_plan_service(device).warmup(shapes)
    return shapes


class ServeState(NamedTuple):
    caches: Any
    last_tokens: torch.Tensor     # (B, 1) int64
    rng: Optional[torch.Generator]
    #: The last step's logits (B, V) float32, None before the first step
    #: (the captured step's static output, which re-prefill gates read).
    logits: Optional[torch.Tensor] = None


def sample(logits: torch.Tensor, temperature: float,
           rng: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits / temperature) → (B,) int64,
    from ``rng``. It is ``torch.multinomial(probs, 1, generator=rng)``'s
    own draw (argmax of p / E, E ~ Exp(1)) without its validity check,
    which reads the probabilities on the host and so cannot be captured
    in a CUDA graph: the same numbers from the same generator state."""
    probs = torch.softmax(logits / temperature, dim=-1)
    e = torch.empty_like(probs).exponential_(1, generator=rng)
    return torch.argmax(probs / e, dim=-1)


def serve_step(state: ServeState, params: Any, *, cfg: ModelConfig,
               temperature: float = 0.0
               ) -> Tuple[ServeState, torch.Tensor]:
    """One decode step for the whole batch → (new state, next tokens).
    The new state holds the same caches, advanced in place, the next
    tokens as ``last_tokens`` and the step's logits."""
    logits, caches = api.decode_step(params, cfg, state.last_tokens,
                                     state.caches)
    # a sharded vocab is gathered: the pick reads every logit of a row
    logits = whole_within(logits[:, -1, :], 0, 1)
    if temperature > 0:
        nxt = sample(logits, temperature, state.rng)
    else:
        nxt = torch.argmax(logits, dim=-1)
    nxt = nxt[:, None]
    return state._replace(caches=caches, last_tokens=nxt,
                          logits=logits), nxt


def make_serve_step(cfg: ModelConfig, **kw):
    return functools.partial(serve_step, cfg=cfg, **kw)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _read_before_written(tree) -> List[torch.Tensor]:
    """The cache tensors a step reads before it writes them: every leaf
    but the K/V buffers, whose slot at the step's position is written
    before the step reads it (the SSM conv tails and states, the lengths,
    the encdec family's cross K/V)."""
    if isinstance(tree, KVCache):
        return [tree.length]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _read_before_written(x)]
    return _leaves(tree)


class CompiledServeStep:
    """A serve step captured in a CUDA graph: each call replays it once
    and returns :attr:`next_tokens`, the static (B, 1) buffer the replay
    writes. The replay reads :attr:`state`'s ``last_tokens`` (copy a
    teacher-forced token into it before a call), advances its caches in
    place, copies the next tokens into ``last_tokens`` and leaves the
    step's logits in ``state.logits``. ``pool_bytes`` is what the graph's
    private memory pool added to the reserved memory; ``capture_ms`` the
    wall time of the warm-up and the capture."""

    def __init__(self, graph, state: ServeState, next_tokens: torch.Tensor,
                 pool_bytes: int, capture_ms: float):
        self.graph, self.state, self.next_tokens = graph, state, next_tokens
        self.pool_bytes, self.capture_ms = pool_bytes, capture_ms

    def __call__(self) -> torch.Tensor:
        self.graph.replay()
        return self.next_tokens


def compile_serve_step(step: Callable, state: ServeState,
                       params: Any) -> CompiledServeStep:
    """Capture ``step`` (:func:`make_serve_step`'s) on ``state`` in a CUDA
    graph, as ``TorchBackend._capture`` captures a walk: one eager run on
    a side stream (cuBLAS and the allocator set up there; the state it
    advanced is put back, see :func:`_read_before_written`), then
    ``capture_begin(capture_error_mode="global")`` on a private pool. The
    graph keeps ``state``'s caches and generator and a copy of its
    ``last_tokens``; a step that returns new cache tensors instead of
    writing them in place raises ``RuntimeError`` (a replay would read
    stale state), and so does any capture error. DTensor caches and
    parameters are captured as they are: a replay writes the local
    shards."""
    device = state.last_tokens.device
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, the state "
                         f"lies on {device}")
    t0 = time.perf_counter()
    state = state._replace(last_tokens=state.last_tokens.long().clone(),
                           logits=None)
    mutable = _read_before_written(state.caches)
    saved = [t.clone() for t in mutable]
    rng = state.rng
    rng_state = rng.get_state() if rng is not None else None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        new, _ = step(state, params)
        if [id(t) for t in _leaves(new.caches)] != \
                [id(t) for t in _leaves(state.caches)]:
            raise RuntimeError("the serve step returned new cache tensors; "
                               "a replayed graph would read stale state")
        for t, s in zip(mutable, saved):
            t.copy_(s)
        if rng is not None:
            rng.set_state(rng_state)
        graph = torch.cuda.CUDAGraph()
        if rng is not None and rng.device.type == "cuda":
            graph.register_generator_state(rng)
        reserved = torch.cuda.memory_reserved(device)
        graph.capture_begin(capture_error_mode="global")
        try:
            new, nxt = step(state, params)
            state.last_tokens.copy_(nxt)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture is already invalid; report the cause
            raise
        graph.capture_end()
        pool = max(0, torch.cuda.memory_reserved(device) - reserved)
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    return CompiledServeStep(graph, state._replace(logits=new.logits), nxt,
                             pool, (time.perf_counter() - t0) * 1e3)


def check_capacity(cfg: ModelConfig, prompt_len: int, max_new: int,
                   max_s: int) -> None:
    """Raise the "KV cache full" ``ValueError`` when a prompt of
    ``prompt_len`` tokens and ``max_new`` more overrun a KV cache of
    ``max_s`` positions: :func:`generate` writes positions 0 to
    prompt_len + max_new - 2. The check is made on the host before the
    first step, since a (captured) step cannot read its position there.
    The SSM family keeps no KV cache, and the hybrid family's reference
    block's is a ring buffer that wraps (the published block's holds every
    position)."""
    need = prompt_len + max_new - 1
    bounded = cfg.family not in ("ssm", "hybrid") or \
        cfg.shared_block == "published"
    if bounded and need > max_s:
        raise ValueError(f"KV cache full: length {max_s} of {max_s} "
                         f"positions; a prompt of {prompt_len} and "
                         f"{max_new} new tokens write {need}")


def generate(params: Any, cfg: ModelConfig, prompt, max_new: int,
             max_s: Optional[int] = None,
             batch_inputs: Optional[Dict[str, Any]] = None,
             temperature: float = 0.0, seed: int = 0,
             monitor: Optional[StragglerMonitor] = None,
             capture: Optional[bool] = None) -> torch.Tensor:
    """Greedy/temperature generation: prompt (B, S0) → (B, S0 + max_new).

    The prompt fills the caches token by token, as in the reference (its
    predictions are ignored). ``batch_inputs`` go to ``api.init_caches``
    (the encdec family's ``frames``). On CUDA the serve step is captured
    once (:func:`compile_serve_step`) and every token, prompt or new, is
    one replay; ``capture=False`` runs the same step eagerly, as it runs
    on the CPU. The state is one
    object throughout: a prompt token is copied into its ``last_tokens``
    before a step, and each step writes its next tokens there. Pass a
    ``monitor`` to feed each decode step's wall time (synchronised with
    the card) into a straggler watchdog.
    """
    device = params.embed.w.device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s0 = prompt.shape
    max_s = max_s or (s0 + max_new + 1)
    check_capacity(cfg, s0, max_new, max_s)
    plan_warmup(cfg, max_s, device=device)
    caches = api.init_caches(params, cfg, b, max_s,
                             batch_inputs=batch_inputs)
    state = ServeState(caches=caches, last_tokens=prompt[:, :1].clone(),
                       rng=torch.Generator(device=device).manual_seed(seed))
    step = make_serve_step(cfg, temperature=temperature)
    if capture is None:
        capture = device.type == "cuda"
    if capture:
        compiled = compile_serve_step(step, state, params)
        state, advance = compiled.state, compiled
    else:
        def advance():
            _, nxt = step(state, params)
            state.last_tokens.copy_(nxt)
            return nxt
    out = torch.empty((b, s0 + max_new), dtype=torch.long, device=device)
    out[:, :s0] = prompt
    # Teacher-forced prefill: feed prompt tokens, ignore predictions.
    for i in range(s0 - 1):
        advance()
        state.last_tokens.copy_(prompt[:, i + 1: i + 2])
    for n in range(max_new):
        t0 = time.perf_counter()
        nxt = advance()
        out[:, s0 + n: s0 + n + 1] = nxt
        if monitor is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            monitor.observe(n, time.perf_counter() - t0)
    return out
