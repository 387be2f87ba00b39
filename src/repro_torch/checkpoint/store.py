"""Checkpoint store: one ``.npy`` per leaf + a JSON manifest, the
reference's on-disk layout (``checkpoint/store.py``).

  * **Layout** — every leaf of the tree is its own ``.npy`` file under the
    step directory, named by its path (``opt/mu/blocks.0.mixer.in_proj.w``
    → ``opt.mu.blocks.0.mixer.in_proj.w.npy``); a ``None`` leaf is a
    manifest entry without a file. A crashed save never corrupts earlier
    steps: writes go to ``step_N.tmp``, then one atomic rename.
  * **Integrity** — the manifest records each leaf's dtype, shape and
    bytes, checked on load; it is written last, so a directory without one
    is incomplete and ``latest_step`` ignores it.
  * **dtypes** — a bfloat16 leaf is stored as its uint16 bits with
    ``"bfloat16"`` in the manifest, as the reference stores it; each
    package reads what the other wrote.

Trees are nested dicts, NamedTuples, lists and tuples of tensors (or
numpy arrays), Python ints and ``None``; a path joins dict keys, field
names and indices with ``/``, as ``jax.tree_util``'s key paths do.

  * **Mesh metadata** — a DTensor leaf is gathered to its full array
    one leaf at a time and copied to the host (every rank takes part;
    rank 0 alone keeps and writes it, as the reference's single-process
    store writes full arrays) and its spec goes into the manifest in the
    reference's JSON form (``["data", null]``, a merged
    entry as a list), beside the mesh's ``mesh_shape``; a plain leaf's
    spec is ``null``.
  * **Elastic restore** — ``restore(..., mesh=)`` lays every leaf out on
    ``mesh`` by its saved spec, dropping axes the mesh no longer has (and
    any that no longer divide), so a checkpoint of one topology restores
    onto another; without a mesh a DTensor in ``like`` keeps its own
    layout.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import (Any, Callable, Dict, Iterator, List, Mapping,
                    Optional, Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.sharding import rules

MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def leaf_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree``, depth first; dict keys sorted, as
    ``jax.tree_util`` flattens them."""
    if isinstance(tree, Mapping):
        children = [(k, tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        children = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        children = list(enumerate(tree))
    else:
        yield prefix, tree
        return
    for key, value in children:
        yield from leaf_paths(value, _join(prefix, key))


def map_leaves(fn: Callable[[str, Any], Any], tree: Any,
               prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, its dicts,
    NamedTuples, lists and tuples rebuilt as they were."""
    if isinstance(tree, Mapping):
        return type(tree)((k, map_leaves(fn, v, _join(prefix, k)))
                          for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*[map_leaves(fn, v, _join(prefix, k))
                            for k, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, _join(prefix, i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"no numeric layout for a leaf of dtype {arr.dtype}")
    return arr, str(arr.dtype)


def _spec_to_json(spec) -> Optional[List]:
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _json_to_spec(entry, mesh, shape) -> rules.Spec:
    """A saved spec on ``mesh``: entries naming an axis the mesh lacks, or
    whose size no longer divides the dim, become ``None``."""
    if entry is None:
        return ()
    sizes = rules.axis_sizes(mesh)
    out = []
    for e, dim in zip(entry, shape):
        axes = tuple(e) if isinstance(e, list) else (e,) if e else ()
        n = 1
        for a in axes:
            n *= sizes.get(a, 0)
        keep = axes and all(a in sizes for a in axes) and dim % n == 0
        out.append((axes if len(axes) > 1 else axes[0]) if keep else None)
    return tuple(out)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def gather(tree: Any, copy: bool = False
           ) -> Tuple[Any, Dict[str, Any], Dict[str, int]]:
    """(``tree`` on the host, {path: spec} of its DTensor leaves, the mesh
    shape). Every rank of the mesh must call it: the gathers are
    collectives. One DTensor leaf at a time is gathered to its full tensor
    on the device, copied to the host and freed before the next, so a save
    needs one leaf's full size on the card beyond the state. Only rank 0
    keeps host arrays (the writer's); the other ranks' tree holds ``None``
    for every tensor. ``copy`` copies a CPU tensor too (for a caller that
    goes on updating its own in place)."""
    specs: Dict[str, Any] = {}
    mesh_shape: Dict[str, int] = {}
    keep = _rank() == 0

    def host(name, leaf):
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            specs[name] = rules.spec_of(leaf.placements, mesh, leaf.ndim)
            mesh_shape.update(rules.axis_sizes(mesh))
            with torch.no_grad():
                whole = leaf.full_tensor()
            return whole.to("cpu", copy=True) if keep else None
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=copy) if keep else None
        return leaf

    return map_leaves(host, tree), specs, mesh_shape


def save(directory: str, step: int, tree: Any,
         specs: Optional[Mapping[str, Any]] = None,
         mesh_shape: Optional[Mapping[str, int]] = None) -> str:
    """Atomic checkpoint save; returns the final step directory. DTensor
    leaves are gathered (on every rank, :func:`gather`) and rank 0
    writes; ``specs`` ({path: spec}) and ``mesh_shape`` add to or replace
    what the DTensors say."""
    final = os.path.join(directory, f"step_{step}")
    tree, found, shape = gather(tree)
    # the ranks that gathered meet again once rank 0 has written
    meet = bool(found) and dist.is_initialized()
    found.update(specs or {})
    shape.update(mesh_shape or {})
    if _rank() != 0:
        if meet:
            dist.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    for name, leaf in leaf_paths(tree):
        if leaf is None:
            entries.append({"name": name, "none": True})
            continue
        arr, dtype = _to_numpy(leaf)
        fn = name.replace("/", ".") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        entries.append({"name": name, "file": fn, "dtype": dtype,
                        "shape": list(arr.shape), "bytes": int(arr.nbytes),
                        "spec": _spec_to_json(found.get(name))})
    manifest = {"step": step, "mesh_shape": dict(shape), "leaves": entries,
                "format": 1}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if meet:
        dist.barrier()
    return final


def steps(directory: str) -> List[int]:
    """The complete checkpoints' steps (those with a manifest), sorted."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(directory, d, MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    done = steps(directory)
    return done[-1] if done else None


def _load(d: str, e: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(os.path.join(d, e["file"]))
    if e["dtype"] == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        dtype = "bfloat16"
    else:
        t = torch.from_numpy(arr)
        dtype = str(arr.dtype)
    if list(arr.shape) != e["shape"] or dtype != e["dtype"] \
            or int(arr.nbytes) != e["bytes"]:
        raise ValueError(f"integrity failure for {e['name']}: manifest says "
                         f"{e['shape']}/{e['dtype']}/{e['bytes']} bytes, "
                         f"file has {list(arr.shape)}/{dtype}/{arr.nbytes}")
    return t


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore(directory: str, step: int, like: Any, mesh=None) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``: each leaf
    on the device of ``like``'s tensor there (else the CPU), a Python int
    where ``like`` holds one, ``None`` where the checkpoint holds none.
    With ``mesh`` every tensor leaf becomes a DTensor on it, laid out by
    its saved spec (elastic re-mesh); a DTensor of ``like`` without a
    mesh keeps its layout."""
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def leaf(name, node):
        e = by_name.get(name)
        if e is None and node is None:
            return None     # the reference writes no entry for a None leaf
        if e is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        if e.get("none"):
            return None
        t = _load(d, e)
        if isinstance(node, int):
            return int(t)
        if node is not None and tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch restoring {name}: checkpoint "
                             f"{tuple(t.shape)} vs target "
                             f"{tuple(node.shape)}")
        if mesh is not None:
            spec = _json_to_spec(e.get("spec"), mesh, t.shape)
            return distribute_tensor(t.to(_mesh_device(mesh)), mesh,
                                     rules.placements_for(spec, mesh),
                                     src_data_rank=None)
        if isinstance(node, DTensor):
            return distribute_tensor(t.to(node.device), node.device_mesh,
                                     node.placements, src_data_rank=None)
        if isinstance(node, torch.Tensor):
            return t.to(node.device)
        return t

    return map_leaves(leaf, like)


def retain(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    for s in steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
