"""Activation-sharding context: sequence parallelism without touching
model code signatures.

Counterpart of the reference's ``sharding/context.py``. A launcher (the
dry-run, the trainer, a sharded server) activates a context naming the
mesh and the batch axes; model code calls :func:`shard_seq` /
:func:`shard_logits` / ... at the residual stream, the LM head and
inside attention, MoE and SSD. Inside the context each hook
redistributes a DTensor to the reference's layout (the counterpart of
``with_sharding_constraint``): the residual stream runs batch-sharded
over (pod, data) and sequence-sharded over ``model`` between blocks, and
DTensor inserts the all-gather / reduce-scatter pairs around the
projections. Outside the context, or on a plain tensor, every hook is
the identity and returns the same object, so the single-device path is
untouched.

The context also enters DTensor's ``implicit_replication``: a plain
tensor that meets a DTensor inside the models (positions, masks, RoPE
tables) counts as replicated.
"""

from __future__ import annotations

import contextlib
import math
import threading
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from .rules import axis_sizes

_ctx = threading.local()


def _state():
    if not hasattr(_ctx, "mesh"):
        _ctx.mesh = None
        _ctx.batch_axes = None
        _ctx.heads_enabled = True
    return _ctx


def default_batch_axes(mesh):
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


@contextlib.contextmanager
def activation_sharding(mesh=None, batch_axes=None, heads: bool = True):
    """Activate the hooks on ``mesh`` (the ambient mesh of
    :func:`repro_torch.launch.mesh.set_mesh` when ``None``).
    ``heads=False`` disables the in-attention head constraints only, as
    the reference's multi-pod dry-run does."""
    if mesh is None:
        from repro_torch.launch.mesh import current_mesh
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("activation_sharding needs a mesh: pass one "
                             "or enter launch.mesh.set_mesh")
    st = _state()
    prev = (st.mesh, st.batch_axes, st.heads_enabled)
    st.mesh = mesh
    st.batch_axes = default_batch_axes(mesh) if batch_axes is None \
        else batch_axes
    st.heads_enabled = heads
    try:
        with implicit_replication():
            yield
    finally:
        st.mesh, st.batch_axes, st.heads_enabled = prev


def active_mesh():
    """The mesh of the active context, or ``None`` outside one."""
    return _state().mesh


def batch_axes():
    """The batch axes of the active context."""
    return _state().batch_axes


def _axsize(sizes, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def placements_of(mesh, shape, spec_entries):
    """Placements of ``spec_entries`` for an array of ``shape``, each entry
    kept only where its mesh size divides the dim (and is at most it),
    the reference's guard; a mesh dim of one device never shards."""
    sizes = axis_sizes(mesh)
    names = mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for i, (dim, ax) in enumerate(zip(shape, spec_entries)):
        size = _axsize(sizes, ax)
        if ax is None or dim % size or dim < size:
            continue
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            if sizes[name] > 1:
                placements[names.index(name)] = Shard(i)
    return tuple(placements)


def attention_layout(mesh, shape):
    """Placements of a (B, S, H, Dh) attention tensor for a core that
    needs the whole sequence: the ``shard_heads`` layout, or, where
    ``model`` does not divide the heads (Arctic's 56 on 16), the batch
    over the data axes and ``model`` together when they divide it."""
    bax = _state().batch_axes or default_batch_axes(mesh)
    heads = placements_of(mesh, shape, (bax, None, "model", None))
    names = mesh.mesh_dim_names
    if "model" not in names or isinstance(heads[names.index("model")],
                                          Shard):
        return heads
    axes = (bax if isinstance(bax, tuple) else (bax,) if bax else ()) + (
        "model",)
    rows = placements_of(mesh, shape, (axes, None, None, None))
    return rows if isinstance(rows[names.index("model")], Shard) else heads


def attention_shards(q, k, v, head_dim: int = 2):
    """This rank's q, k and v for an attention core that needs the whole
    sequence, and q's placements (those of the core's output): q in
    :func:`attention_layout`, k and v with it where ``model`` divides
    their heads, else replicated on ``model`` and cut to the KV heads the
    local query heads read (Yi-9B's 4 KV heads under 32 query heads on 16
    ranks: one each). ``head_dim`` is 2 for (B, S, H, D), 1 for
    (B, H, S, D)."""
    mesh = q.device_mesh
    swap = (lambda d: {1: 2, 2: 1}.get(d, d)) if head_dim == 1 else \
        (lambda d: d)
    shape = [q.shape[swap(i)] for i in range(4)]          # as (B, S, H, D)
    qp = tuple(Shard(swap(p.dim)) if isinstance(p, Shard) else p
               for p in attention_layout(mesh, shape))
    h, hkv = q.shape[head_dim], k.shape[head_dim]
    kp = tuple(Replicate() if isinstance(p, Shard) and p.dim == head_dim
               and hkv % mesh.size(i) else p for i, p in enumerate(qp))
    ql, kl, vl = (t.redistribute(mesh, pl).to_local()
                  for t, pl in ((q, qp), (k, kp), (v, kp)))
    if ql.shape[head_dim] != h and kl.shape[head_dim] == hkv:
        group = h // hkv
        h0, hl = shard_offset(q.shape, mesh, qp, head_dim), ql.shape[head_dim]
        if hl % group and group % hl:
            raise ValueError(f"attention: {hl} local query heads do not "
                             f"map onto whole groups of {group}")
        lo, hi = h0 // group, (h0 + hl - 1) // group + 1
        kl, vl = (t.narrow(head_dim, lo, hi - lo) for t in (kl, vl))
    return ql, kl, vl, qp


def _constrain(x, spec_entries):
    st = _state()
    if st.mesh is None or not isinstance(x, DTensor):
        return x
    placements = placements_of(st.mesh, x.shape, spec_entries)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(st.mesh, placements)


def shard_seq(x):
    """(B, S, d) residual: batch over (pod,data), sequence over model."""
    st = _state()
    if st.mesh is None or x.ndim != 3:
        return x
    return _constrain(x, (st.batch_axes, "model", None))


def shard_logits(x):
    """(B, S, V) logits: batch over (pod,data), vocab over model."""
    st = _state()
    if st.mesh is None or x.ndim != 3:
        return x
    return _constrain(x, (st.batch_axes, None, "model"))


def shard_tokens_hidden(x):
    """(T, d) flattened token activations (MoE internals)."""
    st = _state()
    if st.mesh is None or x.ndim != 2:
        return x
    return _constrain(x, (st.batch_axes, None))


def shard_moe_groups(x):
    """(G, Tg, d) grouped MoE token blocks: groups over the batch axes."""
    st = _state()
    if st.mesh is None or x.ndim != 3:
        return x
    return _constrain(x, (st.batch_axes, None, None))


def shard_heads(x):
    """(B, S, H, Dh) attention tensors: heads over model, full sequence —
    the Megatron TP layout inside the attention block."""
    st = _state()
    if st.mesh is None or x.ndim != 4 or not st.heads_enabled:
        return x
    return _constrain(x, (st.batch_axes, None, "model", None))


def shard_ssd_chunks(x):
    """(B, nc, Q, ...) SSD chunk tensors: batch over (pod,data), chunk
    axis over model."""
    st = _state()
    if st.mesh is None or x.ndim < 3:
        return x
    spec = (st.batch_axes, "model") + (None,) * (x.ndim - 2)
    return _constrain(x, spec)


def shard_ssd_states(x, h_axis: int):
    """SSD inter-chunk states: the heads axis over model."""
    st = _state()
    if st.mesh is None:
        return x
    spec = [None] * x.ndim
    spec[h_axis] = "model"
    return _constrain(x, tuple(spec))


def shard_offset(shape, mesh, placements, dim: int) -> int:
    """Where this rank's shard of ``dim`` starts in the global array of
    ``shape`` laid out by ``placements`` (even ``Shard`` placements; the
    mesh dims sharding ``dim`` split it outer first)."""
    coord = mesh.get_coordinate()
    chunk, parts = 0, 1
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            chunk = chunk * mesh.size(md) + coord[md]
            parts *= mesh.size(md)
    return chunk * (shape[dim] // parts)


def whole_within(x, first: int, last: int):
    """``x`` ready for a view that merges dims ``first..last`` into one: a
    DTensor sharding any of them but the first is gathered on those mesh
    dims (a view cannot redistribute, and not every DTensor release can
    describe a merge of two sharded dims). The identity otherwise."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if isinstance(p, Shard) and first < p.dim <= last
          else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                             pl)


class _GradInLayout(torch.autograd.Function):
    """Identity whose backward hands the gradient on in the forward
    value's layout."""

    @staticmethod
    def forward(ctx, x):
        # a partial sum's gradient is the same on every rank: replicated
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_in_layout(x):
    """``x``, its gradient redistributed to ``x``'s layout on the way back.

    Put after a merge of (heads, head_dim) into one dim: the gradient
    reaching it from the next projection may be sharded over a mesh axis
    that does not divide the heads, and the merge's backward (a view
    splitting that dim) cannot split it. The identity on a plain tensor
    or without autograd."""
    if not isinstance(x, DTensor) or not torch.is_grad_enabled() \
            or not x.requires_grad:
        return x
    return _GradInLayout.apply(x)


def shard_batch(x: torch.Tensor, mesh=None):
    """A plain (B, ...) input as a DTensor batch-sharded over (pod, data)
    on the active (or given) mesh, each rank taking its own rows of the
    same global batch (no communication); the identity outside a
    context."""
    mesh = mesh if mesh is not None else _state().mesh
    if mesh is None or isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import distribute_tensor
    placements = placements_of(mesh, x.shape,
                               (default_batch_axes(mesh),))
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def replicate(x: torch.Tensor, mesh=None):
    """A plain tensor as a replicated DTensor on the active (or given)
    mesh; the identity outside a context."""
    mesh = mesh if mesh is not None else _state().mesh
    if mesh is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
