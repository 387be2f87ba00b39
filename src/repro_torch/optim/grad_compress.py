"""Int8 error-feedback gradient compression, as the reference's
``optim/grad_compress.py``.

Blockwise-symmetric int8 per 256-element block of the flattened leaf,
fp32 scales; the residual of each quantization is added back before the
next one (error feedback), so the quantization noise does not bias
training. It is meant for the cross-pod gradient all-reduce; as in the
reference, no train step calls it. Trees are dicts of tensors keyed by
name.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 (blocks, BLOCK), padded to whole blocks
    scale: torch.Tensor    # fp32 per block
    shape: Tuple[int, ...]


class EFState(NamedTuple):
    residual: Dict[str, torch.Tensor]   # fp32, the gradients' shapes


def init_state(grads: Mapping[str, torch.Tensor]) -> EFState:
    return EFState(residual={n: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device)
                             for n, g in grads.items()})


def _compress_leaf(g: torch.Tensor, r: torch.Tensor
                   ) -> Tuple[Compressed, torch.Tensor]:
    x = g.float() + r
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[: x.numel()].reshape(x.shape)
    return Compressed(q=q, scale=scale[:, 0], shape=tuple(g.shape)), x - deq


def compress(grads: Mapping[str, torch.Tensor], state: EFState
             ) -> Tuple[Dict[str, Compressed], EFState]:
    comp, res = {}, {}
    for name, g in grads.items():
        comp[name], res[name] = _compress_leaf(g, state.residual[name])
    return comp, EFState(residual=res)


def _decompress_leaf(c: Compressed) -> torch.Tensor:
    n = 1
    for d in c.shape:
        n *= d
    deq = (c.q.float() * c.scale[:, None]).reshape(-1)
    return deq[:n].reshape(c.shape)


def decompress(comp: Mapping[str, Compressed]) -> Dict[str, torch.Tensor]:
    return {name: _decompress_leaf(c) for name, c in comp.items()}
