"""The reference's parameter leaves, seen from the port's names.

The reference stacks the layers of ``blocks`` (and of an encoder–decoder's
``encoder`` and ``decoder``) on a leading axis: its leaf
``blocks.mixer.norm.g`` is one (L, d) array where the port holds L
tensors ``blocks.<i>.mixer.norm.g`` of shape (d,). The reference's
optimizers and train step decide by a leaf's rank (weight decay and the
compute-dtype copy from rank 2 on, Muon's matrices at rank 2), so the
port decides by the rank and shape of the reference's leaf.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

import torch

_LAYER = re.compile(r"^(blocks|encoder|decoder)\.(\d+)\.(.+)$")


def reference_name(name: str) -> str:
    """``blocks.<i>.<path>`` → ``blocks.<path>``; other names unchanged."""
    m = _LAYER.match(name)
    return f"{m[1]}.{m[3]}" if m else name


def reference_shape(name: str, p: torch.Tensor, depth: int
                    ) -> Tuple[int, ...]:
    """Shape of the reference's leaf holding ``p``: a layer stack's leaves
    gain the leading axis of the stack's ``depth`` layers."""
    shape = tuple(p.shape)
    return (depth,) + shape if _LAYER.match(name) else shape


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """Rank of the reference's leaf holding ``p``."""
    return p.ndim + 1 if _LAYER.match(name) else p.ndim


def group(names: Iterable[str]) -> Dict[str, List[str]]:
    """The port's names of each reference leaf, a stack's in layer order,
    keyed by the reference's name, in first-seen order."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        m = _LAYER.match(name)
        groups.setdefault(reference_name(name), []).append(
            (int(m[2]) if m else 0, name))
    return {key: [n for _, n in sorted(v)] for key, v in groups.items()}
