"""The port's sharding rules, logical axes, cache specs and activation
hooks against the JAX package's, on the CPU.

* Every parameter of every architecture (published widths, axes and
  shapes from the ``meta`` device; and each smoke config) has logical
  axes, the reference leaf's without its stacking axis ``"layers"``,
  and its spec equals ``repro.sharding.rules.spec_for`` of the reference
  leaf with that axis dropped, on the duck meshes {data: 16, model: 16},
  {pod: 2, data: 16, model: 16} and {data: 4, model: 2}, under both
  parameter policies.
* ``pick_param_policy`` agrees with the reference's at the reference's
  16 GiB budget; at the port's default (one H100's 80 GB) InternVL2-76B
  flips to zero1 on the production mesh.
* ``cache_specs`` of every cache family equals the reference's.
* The activation hooks (the counterparts of
  ``tests/test_sharding_context.py``): the identity outside a context
  and on plain tensors, the reference's layouts on DTensors inside one,
  the previous context restored on exit, and the heads toggle. DTensors
  live on a ``fake`` process group of 8 ranks.
"""

import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro.configs import get as jget, get_smoke as jget_smoke
from repro.launch import specs as jspecs
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, get, get_smoke
from repro_torch.launch import specs
from repro_torch.models import api
from repro_torch.optim.leaves import reference_name
from repro_torch.sharding import context, rules

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
}


def duck(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _reference_leaves(cfg):
    """{dotted reference path: (axes, shape)} of the reference's init."""
    shapes, axes = jspecs.abstract_init(cfg)
    is_axes = lambda x: isinstance(x, tuple) and all(        # noqa: E731
        isinstance(s, str) for s in x)
    flat_axes = jax.tree_util.tree_flatten_with_path(axes,
                                                     is_leaf=is_axes)[0]
    flat_shapes = jax.tree_util.tree_flatten_with_path(shapes)[0]
    key = lambda path: ".".join(k.key for k in path)         # noqa: E731
    shape_of = {key(p): tuple(s.shape) for p, s in flat_shapes}
    return {key(p): (a, shape_of[key(p)]) for p, a in flat_axes}


@pytest.mark.parametrize("size", ["published", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, size):
    cfg = get(arch) if size == "published" else get_smoke(arch)
    jcfg = jget(arch) if size == "published" else jget_smoke(arch)
    ref = _reference_leaves(jcfg)
    shapes, axes = specs.abstract_init(cfg)
    assert set(axes) == set(shapes)          # every parameter has axes
    assert {reference_name(n) for n in shapes} == set(ref)
    for mesh_name, sizes in MESHES.items():
        for policy in ("fsdp", "zero1"):
            port_rules, ref_rules = (rules.rules_for(policy),
                                     jrules.rules_for(policy))
            for name, p in shapes.items():
                ref_axes, ref_shape = ref[reference_name(name)]
                stacked = reference_name(name) != name
                if stacked:
                    assert ref_axes[0] == "layers", name
                    ref_axes, ref_shape = ref_axes[1:], ref_shape[1:]
                    want = tuple(jrules.spec_for(
                        ("layers",) + ref_axes, (1,) + ref_shape,
                        duck(sizes), ref_rules))[1:]
                else:
                    want = tuple(jrules.spec_for(ref_axes, ref_shape,
                                                 duck(sizes), ref_rules))
                assert axes[name] == ref_axes, name
                assert tuple(p.shape) == ref_shape, name
                got = rules.spec_for(axes[name], p.shape, duck(sizes),
                                     port_rules)
                assert got == want, (mesh_name, policy, name, got, want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_policy_batch_spec_and_rules_match_the_reference(mesh_name):
    mesh = duck(MESHES[mesh_name])
    for arch in ARCH_IDS:
        n = get(arch).param_count()
        assert n == jget(arch).param_count()
        assert rules.pick_param_policy(n, mesh, hbm_bytes=16 * 2 ** 30) \
            == jrules.pick_param_policy(n, mesh)
    assert rules.batch_spec(mesh) == tuple(jrules.batch_spec(mesh))
    for policy in ("fsdp", "zero1", "auto"):
        assert rules.rules_for(policy) == jrules.rules_for(policy)
    assert rules.DEFAULT_RULES == jrules.DEFAULT_RULES
    assert rules.ZERO1_PARAM_RULES == jrules.ZERO1_PARAM_RULES


def test_param_policy_budget_is_one_h100():
    """70.55 G params × 8 B / 16 = 35.3 GB ≤ 40 GB: zero1 on the card,
    fsdp at the reference's 16 GiB."""
    mesh = duck(MESHES["16x16"])
    n = get("internvl2_76b").param_count()
    assert rules.H100_HBM_BYTES == 80 * 10 ** 9
    assert rules.pick_param_policy(n, mesh) == "zero1"
    assert jrules.pick_param_policy(n, mesh) == "fsdp"
    assert rules.pick_param_policy(get("arctic_480b").param_count(),
                                   mesh) == "fsdp"


def _port_caches(cfg, batch, max_s):
    model = api.family_module(cfg).init(cfg, None, device="meta")
    bi = None
    if cfg.family == "encdec":
        bi = {"frames": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                    device="meta")}
    return api.init_caches(model, cfg, batch, max_s, batch_inputs=bi)


def _reference_caches(jcfg, batch, max_s):
    import jax.numpy as jnp
    from repro.models import api as japi
    shapes, _ = jspecs.abstract_init(jcfg)
    bi = {}
    if jcfg.family == "encdec":
        bi["frames"] = jax.ShapeDtypeStruct(
            (batch, jcfg.encoder_seq, jcfg.d_model), jnp.float32)
    return jax.eval_shape(
        lambda p, b: japi.init_caches(p, jcfg, batch, max_s,
                                      batch_inputs=b or None), shapes, bi)


def _array_fields(port, ref, prefix=""):
    """(path, port spec, reference spec) of every array field."""
    out = []
    for f in port._fields:
        a, b = getattr(port, f), getattr(ref, f, None)
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            out += _array_fields(a, b, f"{prefix}{f}.")
        elif isinstance(a, tuple):
            out.append((prefix + f, a, tuple(b)))
    return out


@pytest.mark.parametrize("arch", ["yi_9b", "mamba2_370m", "zamba2_1p2b",
                                  "whisper_tiny", "olmoe_1b_7b"])
def test_cache_specs_match_the_reference(arch):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    for sizes in MESHES.values():
        mesh = duck(sizes)
        for batch in (16, 32, 3):
            port = specs.cache_specs(cfg, _port_caches(cfg, batch, 256),
                                     mesh)
            ref = jspecs.cache_specs(jcfg, _reference_caches(jcfg, batch,
                                                             256), mesh)
            fields = _array_fields(port, ref)
            assert fields
            for path, got, want in fields:
                # the reference's specs keep trailing None entries
                while want and want[-1] is None:
                    want = want[:-1]
                while got and got[-1] is None:
                    got = got[:-1]
                assert got == want, (arch, sizes, batch, path)


# ------------------------------------------------ the activation hooks ---

@pytest.fixture
def mesh():
    """A (4, 2) ("data", "model") mesh over a fake world of 8 ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


HOOKS = [(context.shard_seq, (8, 16, 4)),
         (context.shard_logits, (8, 16, 4)),
         (context.shard_tokens_hidden, (8, 4)),
         (context.shard_moe_groups, (8, 16, 4)),
         (context.shard_heads, (8, 16, 4, 8)),
         (context.shard_ssd_chunks, (8, 4, 16, 4)),
         (lambda x: context.shard_ssd_states(x, 2), (8, 4, 4, 2))]


def test_hooks_are_the_identity_outside_a_context(mesh):
    for hook, shape in HOOKS:
        x = torch.zeros(shape)
        assert hook(x) is x
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        assert hook(dx) is dx
    with context.activation_sharding(mesh):
        for hook, shape in HOOKS:
            x = torch.zeros(shape)
            assert hook(x) is x               # plain tensors pass through


def test_hooks_apply_the_reference_layouts(mesh):
    want = {
        context.shard_seq: (Shard(0), Shard(1)),
        context.shard_logits: (Shard(0), Shard(2)),
        context.shard_tokens_hidden: (Shard(0), Replicate()),
        context.shard_moe_groups: (Shard(0), Replicate()),
        context.shard_heads: (Shard(0), Shard(2)),
        context.shard_ssd_chunks: (Shard(0), Shard(1)),
    }
    with context.activation_sharding(mesh):
        for hook, shape in HOOKS:
            x = torch.arange(np.prod(shape), dtype=torch.float32
                             ).reshape(shape)
            dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            out = hook(dx)
            assert isinstance(out, DTensor)
            placements = want.get(hook, (Replicate(), Shard(2)))
            assert tuple(out.placements) == placements, hook
            assert out.shape == x.shape
        # the divisibility guard: 3 rows on 4 data ranks stay replicated
        odd = distribute_tensor(torch.zeros(3, 16, 4), mesh,
                                [Replicate(), Replicate()])
        assert tuple(context.shard_seq(odd).placements) == \
            (Replicate(), Shard(1))


def test_context_restores_and_heads_toggle(mesh):
    assert context.active_mesh() is None
    x = distribute_tensor(torch.zeros(8, 16, 4, 8), mesh,
                          [Replicate(), Replicate()])
    with context.activation_sharding(mesh):
        assert context.active_mesh() is mesh
        assert context.batch_axes() == "data"
        with context.activation_sharding(mesh, heads=False):
            assert context.shard_heads(x) is x
            assert context.shard_seq(x[..., 0]) is not x
        assert tuple(context.shard_heads(x).placements) == \
            (Shard(0), Shard(2))
    assert context.active_mesh() is None
    assert context.shard_heads(x) is x
    # the ambient mesh of launch.mesh.set_mesh, when none is passed
    from repro_torch.launch.mesh import current_mesh, set_mesh
    with set_mesh(mesh):
        assert current_mesh() is mesh
        with context.activation_sharding():
            assert context.active_mesh() is mesh
    assert current_mesh() is None
    with pytest.raises(ValueError, match="needs a mesh"):
        with context.activation_sharding():
            pass


def test_placements_and_specs_round_trip(mesh):
    for spec in [(), ("data",), (None, "model"), ("data", "model"),
                 (("data", "model"),)]:
        pl = rules.placements_for(spec, mesh)
        assert rules.spec_of(pl, mesh, 2) == spec
    assert rules.placements_for((("data", "model"),), mesh) == \
        (Shard(0), Shard(0))
    assert rules.replicated(mesh) == (Replicate(), Replicate())
    assert rules.batch_spec(mesh) == ("data",)
    # a DeviceMesh and its duck give the same specs
    for arch in ("yi_9b", "olmoe_1b_7b"):
        shapes, axes = specs.abstract_init(get_smoke(arch))
        assert rules.params_specs(axes, shapes, mesh) == rules.params_specs(
            axes, shapes, duck(MESHES["4x2"]))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_on_a_fake_world(multi_pod):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    dryrun.ensure_fake_world(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                else {"data": 16, "model": 16})
        assert rules.axis_sizes(mesh) == want
        host = make_host_mesh(model=16)
        assert rules.axis_sizes(host) == {"data": len(mesh.mesh.flatten())
                                          // 16, "model": 16}
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(model=3)
    finally:
        dist.destroy_process_group()
