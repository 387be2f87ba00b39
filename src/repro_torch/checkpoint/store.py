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
names and indices with ``/``, as ``jax.tree_util``'s key paths do. The
mesh specs are written as ``null`` until the port distributes
(ROADMAP A9).
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


def save(directory: str, step: int, tree: Any) -> str:
    """Atomic checkpoint save; returns the final step directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
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
                        "spec": None})
    manifest = {"step": step, "mesh_shape": {}, "leaves": entries,
                "format": 1}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
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


def restore(directory: str, step: int, like: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``: each leaf
    on the device of ``like``'s tensor there (else the CPU), a Python int
    where ``like`` holds one, ``None`` where the checkpoint holds none."""
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
        if isinstance(node, torch.Tensor):
            return t.to(node.device)
        return t

    return map_leaves(leaf, like)


def retain(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    for s in steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
