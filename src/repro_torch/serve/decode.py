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
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import api
from repro_torch.models.transformer import ModelConfig
from repro_torch.runtime.supervisor import StragglerMonitor
from repro_torch.serve.plan_cache import default_plan_service, planner_enabled


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
    rng: torch.Generator


def serve_step(state: ServeState, params: Any, *, cfg: ModelConfig,
               temperature: float = 0.0
               ) -> Tuple[ServeState, torch.Tensor]:
    """One decode step for the whole batch → (new state, next tokens)."""
    logits, caches = api.decode_step(params, cfg, state.last_tokens,
                                     state.caches)
    logits = logits[:, -1, :]
    if temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=state.rng)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    nxt = nxt[:, None]
    return state._replace(caches=caches, last_tokens=nxt), nxt


def make_serve_step(cfg: ModelConfig, **kw):
    return functools.partial(serve_step, cfg=cfg, **kw)


def generate(params: Any, cfg: ModelConfig, prompt, max_new: int,
             max_s: Optional[int] = None,
             batch_inputs: Optional[Dict[str, Any]] = None,
             temperature: float = 0.0, seed: int = 0,
             monitor: Optional[StragglerMonitor] = None) -> torch.Tensor:
    """Greedy/temperature generation: prompt (B, S0) → (B, S0 + max_new).

    The prompt fills the caches token by token, as in the reference (its
    predictions are ignored). ``batch_inputs`` go to ``api.init_caches``
    (the encdec family's ``frames``). Pass a ``monitor`` to feed decode
    step wall times (synchronised with the card) into a straggler
    watchdog.
    """
    device = params.embed.w.device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s0 = prompt.shape
    max_s = max_s or (s0 + max_new + 1)
    plan_warmup(cfg, max_s, device=device)
    caches = api.init_caches(params, cfg, b, max_s,
                             batch_inputs=batch_inputs)
    state = ServeState(caches=caches, last_tokens=prompt[:, :1],
                       rng=torch.Generator(device=device).manual_seed(seed))
    step = make_serve_step(cfg, temperature=temperature)
    # Teacher-forced prefill: feed prompt tokens, ignore predictions.
    for i in range(s0 - 1):
        state, _ = step(state, params)
        state = state._replace(last_tokens=prompt[:, i + 1: i + 2])
    gen = []
    for n in range(max_new):
        t0 = time.perf_counter()
        state, nxt = step(state, params)
        if monitor is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            monitor.observe(n, time.perf_counter() - t0)
        gen.append(nxt)
    return torch.cat([prompt] + gen, dim=1)
