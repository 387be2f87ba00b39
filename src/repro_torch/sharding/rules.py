"""Logical-axis → mesh-axis sharding rules.

Counterpart of the reference's ``sharding/rules.py``. Model code names
every parameter's logical axes (``("embed", "ffn")`` etc., see
:func:`repro_torch.models.api.param_axes`); this module turns them into
a *spec* for a mesh, applying:

  * **TP** — ``ffn``/``heads``/``kv_heads``/``inner``/``vocab`` → ``model``
  * **EP** — ``experts`` → ``model`` (expert parallelism shares the TP
    axis; within an expert the ffn axis is then unsharded)
  * **FSDP/ZeRO-3** — ``embed`` → ``data`` (+ ``pod``): parameters and
    optimizer state sharded over the data axes, gathered per use
  * divisibility guard — an axis is only sharded if its size divides the
    mesh axis size; otherwise it stays replicated.

A spec is a plain tuple with one entry per leading tensor dim: ``None``,
a mesh axis name, or a tuple of names (trailing ``None`` entries
dropped), so ``tuple(jax_partition_spec) == spec`` compares it with the
reference's. :func:`placements_for` turns a spec into DTensor placements
on a :class:`~torch.distributed.device_mesh.DeviceMesh`.

A *mesh* here is a ``DeviceMesh`` (with ``mesh_dim_names``) or anything
whose ``.shape`` maps axis names to sizes, the only thing the reference
reads of a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[Any, ...]

# logical axis → preferred mesh axes. The tuple ("pod", "data") merges
# into one spec entry.
DEFAULT_RULES: Dict[str, Any] = {
    "vocab": "model",
    "embed": ("pod", "data"),   # FSDP
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "inner": "model",
    "experts": "model",
    "layers": None,             # the reference's stacking axis
    "conv_k": None,
}

# ZeRO-1: parameters replicated across the data axes (TP-sharding only);
# optimizer moments keep DEFAULT_RULES (data-sharded).
ZERO1_PARAM_RULES: Dict[str, Any] = dict(DEFAULT_RULES, embed=None)

#: One H100's memory, the default budget of :func:`pick_param_policy`.
H100_HBM_BYTES = 80 * 10 ** 9


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def pick_param_policy(n_params: int, mesh, hbm_bytes: int = H100_HBM_BYTES,
                      dtype_bytes: int = 4) -> str:
    """``auto`` policy: zero1 iff fp32 params + fp32 grads on one TP shard
    stay under half the memory budget (room for the moment slices, bf16
    working copies and activations). The budget defaults to one H100's
    80 GB; the reference's default is a TPU's, so pass ``hbm_bytes`` to
    reproduce its choices."""
    tp = axis_sizes(mesh).get("model", 1)
    per_dev = n_params * dtype_bytes * 2 / tp      # params + grads
    return "zero1" if per_dev <= hbm_bytes / 2 else "fsdp"


def rules_for(policy: str) -> Dict[str, Any]:
    if policy == "zero1":
        return ZERO1_PARAM_RULES
    return DEFAULT_RULES


def _mesh_axis_size(sizes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis if a in sizes)
    return sizes.get(axis, 1)


def _present(sizes: Mapping[str, int], axis):
    """Filter rule axes down to those present in the mesh."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        axes = tuple(a for a in axis if a in sizes)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    return axis if axis in sizes else None


def spec_for(axes: Sequence[str], shape: Sequence[int], mesh,
             rules: Optional[Dict[str, Any]] = None) -> Spec:
    """Spec of one array from its logical axes and shape."""
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    used = set()
    entries = []
    for name, dim in zip(axes, shape):
        target = _present(sizes, rules.get(name))
        size = _mesh_axis_size(sizes, target)
        flat = (target if isinstance(target, tuple)
                else (target,) if target else ())
        if (target is None or dim % max(size, 1) != 0
                or any(a in used for a in flat)):
            entries.append(None)
        else:
            entries.append(target)
            used.update(flat)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def params_specs(axes: Mapping[str, Sequence[str]],
                 params: Mapping[str, Any], mesh,
                 rules: Optional[Dict[str, Any]] = None) -> Dict[str, Spec]:
    """{name: spec} for a {name: tensor (or anything with ``.shape``)}
    dict, from ``axes`` {name: logical axes}."""
    return {name: spec_for(axes[name], tuple(p.shape), mesh, rules)
            for name, p in params.items()}


def placements_for(spec: Spec, mesh) -> Tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(i)`` on
    every mesh dim of more than one device that entry ``i`` names,
    ``Replicate()`` on the rest.
    An entry naming several axes (``("pod", "data")``) shards that tensor
    dim over each of them, the outer mesh dim first, as the reference's
    merged entry does."""
    placements = [Replicate()] * len(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            md = mesh.mesh_dim_names.index(name)
            if mesh.size(md) > 1:        # one device holds the whole dim
                placements[md] = Shard(i)
    return tuple(placements)


def spec_of(placements, mesh, ndim: int) -> Spec:
    """The spec of DTensor ``placements`` on ``mesh`` for an array of
    ``ndim`` dims, the inverse of :func:`placements_for`."""
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    spec = [None if not e else e[0] if len(e) == 1 else tuple(e)
            for e in entries]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def shardings_of(specs: Mapping[str, Spec], mesh) -> Dict[str, Tuple]:
    return {name: placements_for(s, mesh) for name, s in specs.items()}


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of an array of ``shape`` under
    ``spec`` (specs divide evenly, by the divisibility guard)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= _mesh_axis_size(sizes, entry)
    return tuple(out)


def local_bytes(shape: Sequence[int], spec: Spec, mesh,
                dtype: torch.dtype) -> int:
    return math.prod(local_shape(shape, spec, mesh)) * dtype.itemsize


def batch_spec(mesh) -> Spec:
    """Data-parallel batch sharding over (pod, data)."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def replicated(mesh) -> Tuple:
    """Placements of a fully replicated array."""
    return placements_for((), mesh)
