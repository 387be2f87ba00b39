"""Production-mesh dry-run: trace every (arch × shape × mesh) cell on a
fake process group and report its per-device costs.

Counterpart of the reference's ``launch/dryrun.py``, which compiles each
cell for 512 placeholder TPU devices. Here a ``fake`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``)
backs the (16, 16) and (2, 16, 16) meshes, and rank 0 traces the step
under ``FakeTensorMode``: no device, no allocation, every tensor a
DTensor whose local shard is rank 0's. Per cell this module

  1. builds the abstract state (:mod:`.specs`): parameters, moments,
     batch and caches, sharded by the logical-axis rules;
  2. runs the train step, the prefill (the encdec and hybrid families:
     the teacher-forced forward) or the decode step inside
     :func:`~repro_torch.sharding.context.activation_sharding`
     (``heads=not multi_pod``, as the reference);
  3. records with :class:`~repro_torch.launch.hlo.CostRecorder` one
     device's FLOPs, unfused op bytes, collectives and activation peak,
     and sums the local shard bytes of the state;
  4. writes the roofline terms with the H100's figures.

There is no depth correction. The reference's exists because XLA's cost
analysis counts a ``lax.scan`` body once; the port's layer loop is
Python, so every layer is traced and counted. ``--no-depth-correct`` is
accepted for the reference's CLI and changes nothing.

One process holds one default process group, so the dry-run runs in a
process of its own and refuses to run where a real group is initialised.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun_torch.json
  python -m repro_torch.launch.dryrun --smoke --arch olmoe-1b-7b --shape train_4k
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get,
                                 get_smoke, normalize, shape_applicable)
from repro_torch.launch import hlo as hlo_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import api
from repro_torch.models.transformer import ModelConfig
from repro_torch.serve.decode import serve_step
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.context import activation_sharding
from repro_torch.train.train_step import train_step


#: ``--smoke``: each shape cell at a size a CPU traces in seconds, for
#: the smoke configs (the mesh stays the production one).
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 256, 32, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 256, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 256, 32, "decode"),
    "long_500k": ShapeSpec("long_500k", 1024, 1, "decode"),
}


def _cfg_for_cell(arch: str, shape_name: str,
                  smoke: bool = False) -> ModelConfig:
    cfg = get_smoke(arch) if smoke else get(arch)
    if SHAPES[shape_name].kind == "train":
        # per-layer remat bounds activation memory at seq 4096 × batch 256
        cfg = dataclasses.replace(cfg, remat="full")
    return cfg


def ensure_fake_world(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (one is re-made when its size differs); a real group raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the dry-run needs a process of its own: a "
                f"{dist.get_backend()} process group is initialised here")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tensors: Iterable[Any]) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _leaves(tree) -> Iterable[Any]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _spec_bytes(cfg: ModelConfig, mesh, dtype, policy: str,
                moments: bool) -> int:
    """The state's local bytes from the rules alone: parameters by
    ``policy`` (and two float32 moments by the FSDP rules)."""
    shapes, specs, _ = specs_lib.param_shardings(cfg, mesh, dtype, policy)
    total = sum(shrules.local_bytes(s.shape, specs[n], mesh, dtype)
                for n, s in shapes.items())
    if moments:
        _, fsdp, _ = specs_lib.param_shardings(cfg, mesh, dtype, "fsdp")
        total += 2 * sum(shrules.local_bytes(s.shape, fsdp[n], mesh,
                                             torch.float32)
                         for n, s in shapes.items())
    return total


def _even_strided_shard(original):
    """``_StridedShard.local_shard_size_and_offset`` with a closed form
    for the even case.

    The library splits ``torch.arange`` of the whole dim into the
    placement's pieces to find a rank's size and first offset: a
    (batch · sequence) dim of a million positions, at every cost estimate
    DTensor makes while choosing a strategy, which takes a 3-axis mesh
    beyond any time limit. When ``split_factor × num_chunks`` divides the
    dim every piece holds ``q = size / (split_factor · num_chunks)``
    positions, a rank holds ``split_factor · q`` of them, the first at
    ``rank · q``; other cases (and the full offset list) go to the
    library."""
    from torch.distributed.tensor import placement_types
    Mode = getattr(placement_types, "_StridedShardOffsetMode", None)
    if Mode is None:        # a release without the offset modes
        return original

    def fast(self, curr_local_size, num_chunks, rank,
             offset_mode=Mode.FIRST):
        mode = Mode(offset_mode)
        sf = self._split_factor_int()
        if (mode is Mode.ALL or not isinstance(curr_local_size, int)
                or not isinstance(rank, int)
                or curr_local_size % (sf * num_chunks)):
            return original(self, curr_local_size, num_chunks, rank,
                            offset_mode)
        q = curr_local_size // (sf * num_chunks)
        if mode is Mode.NONE:
            return sf * q, None
        return sf * q, (rank * q if q else -1)

    return fast


@contextlib.contextmanager
def _index_math():
    """DTensor's shard-offset arithmetic, fast and on real tensors, and
    the card's all-to-all.

    ``_StridedShard.local_shard_size_and_offset`` (the layout of a
    flattened (batch, sequence) activation with both dims sharded) takes
    the closed form of :func:`_even_strided_shard`; it and
    ``_compute_local_shape_and_global_offset`` (a sharded argmax's global
    indices) otherwise compute offsets with ``torch.arange(...)`` and
    read them back, which under an active ``FakeTensorMode`` holds no
    values. The arithmetic describes the layout, not the step, so it runs
    outside the fake mode here, unrecorded. A shard-to-shard move takes
    the all-to-all a CUDA mesh runs, not the all-gather DTensor falls
    back to on a CPU mesh (the fake group's)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils, placement_types
    _StridedShard = getattr(placement_types, "_StridedShard", object)

    def real(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily(), hlo_lib.muted():
                return fn(*args, **kwargs)
        return wrapped

    from torch.distributed import _functional_collectives as funcol

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        # what a CUDA mesh runs: the production meshes are the card's
        group = funcol._group_or_group_name(
            funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                     shard_dim, group)

    patches = {(_StridedShard, "local_shard_size_and_offset"):
               lambda f: _even_strided_shard(real(f)),
               (_utils, "_compute_local_shape_and_global_offset"): real}
    if hasattr(funcol, "_resolve_group") and hasattr(
            funcol, "_group_or_group_name"):
        patches[placement_types, "shard_dim_alltoall"] = lambda f: alltoall
    # a torch release without one of these has no need of its patch
    saved = {site: site[0].__dict__[site[1]] for site in patches
             if site[1] in site[0].__dict__}
    for (owner, name), value in saved.items():
        setattr(owner, name, patches[owner, name](value))
    try:
        yield
    finally:
        for (owner, name), value in saved.items():
            setattr(owner, name, value)


def trace_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               heads: bool = True, policy: str = "auto") -> Dict[str, Any]:
    """Trace one step of ``shape``'s kind for ``cfg`` on ``mesh`` (a fake
    world of its size must be initialised) → raw per-device costs."""
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.perf_counter()
    with fake, _index_math(), activation_sharding(mesh, heads=heads):
        if shape.kind == "train":
            state, shard = specs_lib.abstract_train_state(cfg, mesh,
                                                          policy=policy)
            policy = shard["policy"]
            batch, _ = specs_lib.abstract_batch(cfg, shape, mesh)
            # the 0-d step counters are not laid out by the specs
            state_b = _local_bytes(t for t in _leaves((state.params,
                                                       state.opt))
                                   if t.dim())
            spec_b = _spec_bytes(cfg, mesh, torch.float32, policy, True)
            inputs_b = _local_bytes(_leaves(batch))
            with hlo_lib.CostRecorder() as rec:
                train_step(state, batch, cfg=cfg)
        else:
            policy = "fsdp"
            model, _ = specs_lib.abstract_model(cfg, mesh, torch.bfloat16)
            state_b = _local_bytes(model.parameters())
            spec_b = _spec_bytes(cfg, mesh, torch.bfloat16, policy, False)
            if shape.kind == "prefill" and cfg.family in ("encdec",
                                                          "hybrid"):
                batch, _ = specs_lib.abstract_batch(cfg, shape, mesh)
                batch.pop("labels")
                inputs_b = _local_bytes(_leaves(batch))
                with torch.no_grad(), hlo_lib.CostRecorder() as rec:
                    api.forward_train(model, cfg, batch)
            else:
                serve, _, _ = specs_lib.abstract_serve_state(
                    cfg, shape, mesh, model=model)
                inputs_b = _local_bytes(_leaves(serve.caches))
                if shape.kind == "prefill":
                    batch, _ = specs_lib.abstract_batch(cfg, shape, mesh)
                    batch.pop("labels")
                    inputs_b += _local_bytes(_leaves(batch))
                    with hlo_lib.CostRecorder() as rec:
                        api.prefill(model, cfg, batch, serve.caches)
                else:
                    with hlo_lib.CostRecorder() as rec:
                        serve_step(serve, model, cfg=cfg)
    return {"trace_s": time.perf_counter() - t0, "policy": policy,
            "flops": rec.flops, "bytes": rec.bytes, "trace": rec.trace,
            "state_bytes": state_b, "state_bytes_from_specs": spec_b,
            "inputs_bytes": inputs_b, "activation_peak": rec.peak}


def cell_result(cfg: ModelConfig, shape: ShapeSpec, mesh_tag: str,
                sizes: Dict[str, int], raw: Dict[str, Any]) -> Dict:
    """The reference's per-cell record from :func:`trace_step`'s costs."""
    chips = 1
    for n in sizes.values():
        chips *= n
    coll = hlo_lib.collective_stats(raw["trace"])
    roof = hlo_lib.Roofline(
        flops_per_device=raw["flops"], bytes_per_device=raw["bytes"],
        collective_bytes=coll.total_bytes, chips=chips,
        link_bw=hlo_lib.link_bandwidth(sizes))
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens
    peak = raw["state_bytes"] + raw["inputs_bytes"] + raw["activation_peak"]
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_tag,
        "kind": shape.kind, "chips": chips, "policy": raw["policy"],
        "trace_s": round(raw["trace_s"], 1),
        "params": n_params, "active_params": n_active,
        "depth_note": "direct (every layer traced: the layer loop is "
                      "Python, no scan to correct for)",
        "bytes_per_device": {
            "state": raw["state_bytes"],
            "state_from_specs": raw["state_bytes_from_specs"],
            "inputs": raw["inputs_bytes"],
            "activation_peak": raw["activation_peak"],
            "peak_est": peak,
        },
        "flops_per_device": raw["flops"],
        "op_bytes_per_device": raw["bytes"],
        "bytes_convention": "unfused: input + output bytes of every "
                            "local op that is not a view",
        "collectives": {"counts": coll.counts, "bytes": coll.bytes_},
        "collective_bytes": coll.total_bytes,
        "link_bw": roof.link_bw,
        "t_compute": roof.t_compute,
        "t_memory": roof.t_memory,
        "t_collective": roof.t_collective,
        "bottleneck": roof.bottleneck,
        "model_flops": model_flops,
        "model_flops_ratio": roof.model_flops_ratio(model_flops),
        "roofline_fraction": roof.roofline_fraction(model_flops),
    }


def trace_cell(cfg: ModelConfig, shape_name: str, multi_pod: bool,
               policy: str = "auto", smoke: bool = False) -> Dict[str, Any]:
    """One production cell (its ``--smoke`` size with ``smoke``): the
    fake world, the mesh and the trace."""
    dims, names = production_shape(multi_pod)
    world = 1
    for n in dims:
        world *= n
    ensure_fake_world(world)
    # Every rule shards "pod" and "data" together (the batch and the FSDP
    # axes), so the (2, 16, 16) mesh traces as (32, 16) ("data", "model")
    # over the same ranks: the same local shards and collectives, while
    # DTensor plans its layouts over two mesh dims instead of three.
    mesh = init_device_mesh("cpu", (world // dims[-1], dims[-1]),
                            mesh_dim_names=("data", "model")) \
        if multi_pod else make_production_mesh()
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    raw = trace_step(cfg, shape, mesh, heads=not multi_pod, policy=policy)
    tag = "x".join(str(n) for n in dims)
    return cell_result(cfg, shape, tag, dict(zip(names, dims)), raw)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             depth_correct: bool = True, smoke: bool = False
             ) -> Dict[str, Any]:
    """``depth_correct`` is the reference's flag; the port traces every
    layer, so it changes nothing."""
    cfg = _cfg_for_cell(arch, shape_name, smoke)
    run, why = shape_applicable(cfg, SHAPES[shape_name])
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if not run:
        return {"arch": cfg.name, "shape": shape_name, "mesh": mesh_tag,
                "skipped": True, "reason": why}
    return trace_cell(cfg, shape_name, multi_pod, smoke=smoke)


def write_atomic(path: str, results) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(results, f, indent=1)
    os.replace(path + ".tmp", path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"),
                    default="off")
    ap.add_argument("--no-depth-correct", action="store_true",
                    help="accepted for the reference's CLI; the port "
                         "traces every layer and corrects nothing")
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at SMOKE_SHAPES' sizes")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else (
        normalize(args.arch),)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    pods = {"off": (False,), "on": (True,), "both": (False, True)}[
        args.multi_pod]

    results = []
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                tag = f"{arch} × {shape_name} × {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_cell(arch, shape_name, mp,
                                 depth_correct=not args.no_depth_correct,
                                 smoke=args.smoke)
                    results.append(r)
                    if r.get("skipped"):
                        print(f"[skip] {tag}: {r['reason']}", flush=True)
                    else:
                        print(
                            f"[ ok ] {tag}: trace={r['trace_s']}s "
                            f"peak={r['bytes_per_device']['peak_est']/2**30:.2f}GiB "
                            f"tc={r['t_compute']*1e3:.2f}ms "
                            f"tm={r['t_memory']*1e3:.2f}ms "
                            f"tl={r['t_collective']*1e3:.2f}ms "
                            f"→ {r['bottleneck']} "
                            f"roofline={r['roofline_fraction']:.2%}",
                            flush=True)
                except Exception as e:   # noqa: BLE001 — record, go on
                    failures += 1
                    traceback.print_exc()
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    results.append({"arch": arch, "shape": shape_name,
                                    "mesh": "2x16x16" if mp else "16x16",
                                    "error": f"{type(e).__name__}: {e}"})
                if args.out:
                    # incremental: a partial sweep still leaves a usable
                    # file (atomic rename)
                    write_atomic(args.out, results)
    if args.out:
        print(f"wrote {args.out}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
