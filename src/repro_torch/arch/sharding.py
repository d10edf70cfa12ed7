"""Partition rules: param path -> PartitionSpec, divisibility-aware (a
port of ``repro.arch.sharding``), and their DTensor placements.

Policy, as in JAX:
  * weights shard their LARGEST model-parallel-friendly dim on "model"
    (d_ff, vocab, fused-QKV output, expert dim when divisible),
  * a dim is sharded only if evenly divisible by the axis size, else the
    next preference is tried, else replicated (the 8-kv-head /
    16-way-axis case: the fused kv projection output 1024 shards, the
    head count would not),
  * stacked-layer leaves get a leading ``None`` for the layer dim,
  * batch dims of activations shard on "data" (and "pod" across pods).

Rules are keyed by the LAST path component, with a small table of
dim-index preferences.  :func:`param_pspecs` walks a param tree with
:func:`repro_torch.utils.pytree.tree_map_with_path`; the port's trees
carry JAX's key names (``arch.common.params_from_numpy``).

:class:`PartitionSpec` is the port's own: a tuple with one entry a dim,
each ``None``, a mesh axis name, or a tuple of axis names.
:func:`placements` turns it into one DTensor placement a mesh dim
(``Shard(d)`` or ``Replicate()``); a tuple entry ``("pod", "data")``
shards dim d over both mesh dims, pod-major as JAX splits it (DTensor
splits a dim sharded on several mesh dims in mesh-dim order).

The activation hints (:func:`constrain_act`, :func:`constrain_attn`)
are the identity (the same object) on a plain tensor or without a
policy: every one-process path is unchanged.  On a DTensor under
:func:`activation_policy` they ``redistribute`` to the placements of
JAX's ``with_sharding_constraint`` spec.  GSPMD reshards where an op's
operands disagree without being told, and picks layouts by its own
costs; DTensor must be told.  The helpers that tell it, each the
identity (or the plain ``reshape``) on plain tensors, and the call sites
that use them:

  * :func:`split_heads` (q/k/v projections): a fused projection output
    sharded where the shard would not fall on head boundaries
    (Qwen2.5-3B's 2 KV heads x 128 on a 16-wide "model" axis) is
    replicated on that mesh dim before the view; partial sums of an
    FSDP contraction are reduced to whole heads;
  * :func:`merge_heads` (the attention's output projection): under
    autograd, a head count the mesh does not divide gets its gradient
    gathered before the reshape's backward;
  * :func:`match_heads` (``nn/attention.py``): K/V repeated to q's heads
    and sharded as q, so that each rank attends its own rows and heads;
  * :func:`keep_batch` (``nn/ssm.py``, ``nn/rglru.py``): the
    recurrences' inputs sharded on heads or channels, never on the
    sequence they walk;
  * :func:`gather_fsdp` (every family's layer bodies): a layer's FSDP
    weight shards gathered on use;
  * ``constrain_act`` after the residual adds and on the norms' outputs
    (``nn/layers.py``): the residual's pending sums over "model"
    resolved, the projections' inputs whole on d.

:func:`serving_mode` is the entry points' ``torch.inference_mode()``,
except on DTensor inputs, where it is ``torch.no_grad()``: DTensor's
ops build views (``torch.unbind`` of the stacked layers among them)
that inference tensors refuse.  The choice is made from the arguments,
before any op.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.utils.pytree import tree_leaves, tree_map_with_path

PyTree = Any


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a dim, ``None`` (replicated),
    a mesh axis name, or a tuple of axis names (the dim split over all
    of them, the first the major one)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# name -> dim-index preferences for the "model" axis; dim indices are
# for the UNSTACKED param (no leading layer dim).  JAX's table.
_RULES: dict[str, tuple[int, ...]] = {
    # embeddings / heads
    "embed": (0,),          # (V, d): shard vocab
    "lm_head": (1,),        # (d, V): shard vocab
    "pos_embed": (),
    # attention
    "wq": (1,), "wk": (1,), "wv": (1,), "wo": (0,),
    "bq": (0,), "bk": (0,), "bv": (0,),
    # mlp
    "w_gate": (1,), "w_up": (1,), "w_down": (0,),
    "w_in": (1,), "w_out": (0,), "b_in": (0,), "b_out": (),
    # moe (stacked (E, d, ff) / (E, ff, d)): prefer expert dim, then hidden
    "moe_w_gate": (0, 2), "moe_w_up": (0, 2), "moe_w_down": (0, 1),
    "router": (),
    # mamba2
    "in_proj": (1,), "out_proj": (0,), "conv_w": (1,), "conv_b": (0,),
    "a_log": (), "dt_bias": (), "d_skip": (), "norm_scale": (),
    # rglru / griffin
    "w_in_x": (1,), "w_in_gate": (1,), "w_a": (1,), "w_x": (1,),
    "b_a": (0,), "b_x": (0,), "lam": (0,),
    # norms / misc
    "scale": (), "bias": (), "b": (),
}


def _spec_for(name: str, shape: tuple[int, ...], model_axis: str, axis_size: int,
              stacked: bool, fsdp_axes: tuple[str, ...] = (), fsdp_size: int = 1) -> P:
    prefs = _RULES.get(name, None)
    ndim = len(shape)
    off = 1 if stacked else 0
    entries: list = [None] * ndim
    if prefs is None:
        # default: shard the largest divisible dim (skipping the layer dim)
        order = sorted(range(off, ndim), key=lambda i: -shape[i])
        prefs_abs = order
    else:
        prefs_abs = [p + off for p in prefs]
    for dim in prefs_abs:
        if dim < ndim and shape[dim] % axis_size == 0 and shape[dim] >= axis_size:
            entries[dim] = model_axis
            break
    if fsdp_axes and fsdp_size > 1:
        # serving/FSDP: additionally shard the largest remaining divisible
        # dim over the data axes (weights all-gather per layer on use)
        cands = sorted(
            (i for i in range(off, ndim) if entries[i] is None),
            key=lambda i: -shape[i],
        )
        for dim in cands:
            if shape[dim] % fsdp_size == 0 and shape[dim] >= fsdp_size:
                entries[dim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                break
    return P(*entries)


def param_pspecs(params: PyTree, *, model_axis: str = "model", axis_size: int,
                 fsdp_axes: tuple[str, ...] = (), fsdp_size: int = 1,
                 stacked_subtrees: tuple[str, ...] = ("layers", "enc_layers", "dec_layers", "blocks")) -> PyTree:
    """PartitionSpec tree matching ``params`` (any leaves with a
    ``shape``: tensors, fake or meta tensors)."""

    def fn(path, leaf):
        keys = [str(k) for k in path]
        name = keys[-1]
        stacked = any(k in stacked_subtrees for k in keys[:-1])
        # disambiguate MoE expert weights from dense MLP weights
        if name in ("w_gate", "w_up", "w_down") and (len(leaf.shape) - (1 if stacked else 0)) == 3:
            name = "moe_" + name
        return _spec_for(name, tuple(leaf.shape), model_axis, axis_size, stacked,
                         fsdp_axes, fsdp_size)

    return tree_map_with_path(fn, params)


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> dict[str, int]:
    """A DeviceMesh's dim widths by name (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dim_axes(mesh) -> list[tuple[str, ...]]:
    """The axes each mesh dim stands for: a dim named ``"pod+data"``
    (``launch.mesh.flatten_data_axes``) stands for pod and data
    flattened, pod-major."""
    return [tuple(name.split("+")) for name in mesh.mesh_dim_names]


def _axis_dims(mesh, axes: tuple[str, ...]) -> list[int]:
    """The mesh dims that ``axes`` (in order) cover; a flattened dim must
    be covered whole, in its order.  Raises ``ValueError`` otherwise."""
    dims, rest = [], list(axes)
    for i, own in enumerate(_dim_axes(mesh)):
        if rest and rest[0] in own:
            if tuple(rest[:len(own)]) != own:
                raise ValueError(f"axes {axes} split the mesh dim {'+'.join(own)!r}")
            dims.append(i)
            rest = rest[len(own):]
        elif any(a in own for a in rest):
            raise ValueError(f"axes {axes} are not in mesh order {mesh.mesh_dim_names}")
    if rest:
        raise ValueError(f"axes {tuple(rest)} of {axes} are not on the mesh {mesh.mesh_dim_names}")
    return dims


def data_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes: ("pod","data") when the pod axis exists."""
    names = {a for own in _dim_axes(mesh) for a in own}
    return tuple(a for a in ("pod", "data") if a in names)


def axes_size(mesh, axes) -> int:
    """The product of the widths of ``axes`` (a name or a tuple)."""
    size = 1
    for i in _axis_dims(mesh, (axes,) if isinstance(axes, str) else tuple(axes)):
        size *= mesh.shape[i]
    return size


def placements(spec, mesh) -> tuple:
    """One DTensor placement a mesh dim for ``spec``: ``Shard(d)`` on
    each mesh dim that an entry d names, ``Replicate()`` on the others.
    A tuple entry must name its axes in mesh order (pod-major), the
    order DTensor splits a dim sharded on several mesh dims; on a mesh
    whose dim stands for flattened axes (``"pod+data"``) the entry
    ``("pod", "data")`` is one ``Shard(d)`` there.  An axis named twice,
    not on the mesh, or splitting a flattened dim raises
    ``ValueError``."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for i in _axis_dims(mesh, (entry,) if isinstance(entry, str) else tuple(entry)):
            if out[i] != Replicate():
                raise ValueError(f"axis {names[i]!r} named twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def shardings_for(mesh, spec_tree: PyTree) -> PyTree:
    """The placements of every spec of ``spec_tree`` (its structure)."""
    return tree_map_with_path(lambda _, s: placements(s, mesh), spec_tree,
                              is_leaf=lambda x: isinstance(x, PartitionSpec))


def serving_mode(fn):
    """``fn`` under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` when any argument holds a DTensor (module
    docstring)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        distributed = any(isinstance(t, DTensor)
                          for t in tree_leaves([list(args), list(kwargs.values())]))
        with torch.no_grad() if distributed else torch.inference_mode():
            return fn(*args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------------
# Activation-sharding policy (residual-stream constraints)
#
# Pins the residual stream to (batch -> data axes, seq -> optional
# "model" for sequence parallelism, d_model -> replicated) at layer
# boundaries, so that activations never inherit an FSDP weight's
# sharding (batch replicated, d_model scattered over "data").
# ---------------------------------------------------------------------------

_ACT_POLICY: ContextVar = ContextVar("act_policy", default=None)


@contextmanager
def activation_policy(batch_axes, *, seq_axis=None, seq_axis_size: int = 1,
                      attn_axis=None, attn_axis_size: int = 1,
                      attn_seq_fallback: bool = True):
    """Enable residual-stream constraints (JAX's arguments).

    ``batch_axes``: mesh axis (or tuple) for the batch dim.
    ``seq_axis``: optional axis for the seq dim (sequence parallelism).
    ``attn_axis``: optional axis to pin attention internals ((B,S,H,hd)
    tensors and flash-scan carries): heads when divisible, else the q
    seq dim.
    """
    tok = _ACT_POLICY.set(
        {"batch": batch_axes, "seq": seq_axis, "seq_size": seq_axis_size,
         "attn": attn_axis, "attn_size": attn_axis_size,
         "attn_seq_fallback": attn_seq_fallback}
    )
    try:
        yield
    finally:
        _ACT_POLICY.reset(tok)


def _divisible(n: int, k: int) -> bool:
    return k > 1 and n % k == 0 and n >= k


def _batch_entry(t: DTensor, dim: int, batch):
    """The policy's batch axes for ``dim`` when they divide it, else
    None: a DTensor shard that does not divide cannot be viewed again
    (GSPMD pads it instead)."""
    if not batch:
        return None
    return batch if _divisible(t.shape[dim], axes_size(t.device_mesh, batch)) else None


def _constrain(t: DTensor, entries: list) -> DTensor:
    want = placements(P(*entries), t.device_mesh)
    if tuple(t.placements) == want:
        return t
    return t.redistribute(t.device_mesh, want)


def constrain_attn(t, layout: str, *, kv: bool = False):
    """Pin attention internals.  layout: 'bshd' for (B,S,H,hd) q/k/v,
    'bhsd' for (B,H,S,hd) scan accs, 'bhs' for (B,H,S) softmax stats.

    Prefers sharding H on the attn axis, falling back to the QUERY seq
    dim.  K/V tensors (``kv=True``) never shard their seq dim (a blocked
    attention slices it); they replicate heads instead.  The identity on
    a plain tensor or without an attn axis in the policy.
    """
    pol = _ACT_POLICY.get()
    if pol is None or not pol.get("attn") or not isinstance(t, DTensor):
        return t
    ax, size = pol["attn"], pol["attn_size"]
    dims = {c: i for i, c in enumerate(layout)}
    entries: list = [None] * t.ndim
    if "b" in dims:
        entries[dims["b"]] = _batch_entry(t, dims["b"], pol["batch"])
    h_i, s_i = dims.get("h"), dims.get("s")
    if h_i is not None and _divisible(t.shape[h_i], size):
        entries[h_i] = ax
    elif (not kv) and pol.get("attn_seq_fallback", True) and s_i is not None \
            and _divisible(t.shape[s_i], size):
        # query-seq fallback (serve paths)
        entries[s_i] = ax
    elif not kv:
        # nothing shardable on the model axis: constraining batch alone
        # would replicate the attention compute across "model"
        return t
    return _constrain(t, entries)


def constrain_act(x):
    """Pin a (B, S, d) activation to the policy: batch on the policy's
    axes, seq on its seq axis when that divides it, d replicated.  The
    identity on a plain tensor, on another rank than 3, or without a
    policy."""
    pol = _ACT_POLICY.get()
    if pol is None or x.ndim != 3 or not isinstance(x, DTensor):
        return x
    seq = (
        pol["seq"]
        if (pol["seq"] and x.shape[1] % max(pol["seq_size"], 1) == 0
            and x.shape[1] >= pol["seq_size"])
        else None
    )
    return _constrain(x, [_batch_entry(x, 0, pol["batch"]), seq, None])


STACKED = ("layers", "enc_layers", "dec_layers", "blocks")


def gather_fsdp(tree):
    """Every DTensor leaf of ``tree`` with its shards on the data axes
    (FSDP's, ``param_pspecs(..., fsdp_axes=...)``) gathered, its "model"
    shards kept: JAX's "weights all-gather per layer on use".  Subtrees
    named in :data:`STACKED` (the L-stacked layers) are left as they
    are: each layer body gathers its own slice, so that one layer's
    weights are whole at a time (under remat, again in the backward
    pass, whose gradient comes back reduce-scattered).  DTensor left to
    itself gathers the batch's activations where a weight's input dim is
    split over "data".  The identity on plain tensors."""
    if isinstance(tree, dict):
        return {k: v if k in STACKED else gather_fsdp(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather_fsdp(v) for v in tree]
    if not isinstance(tree, DTensor):
        return tree
    data = {i for i, own in enumerate(_dim_axes(tree.device_mesh)) if {"pod", "data"} & set(own)}
    pl = [Replicate() if i in data and isinstance(p, Shard) else p
          for i, p in enumerate(tree.placements)]
    return tree if pl == list(tree.placements) else tree.redistribute(tree.device_mesh, pl)


def resolve_partial(t):
    """A DTensor's pending partial reductions (sums, means) resolved now,
    on each mesh dim that holds one; the identity on a plain tensor.
    Where a mean over a sharded dim meets a sum (the MoE's aux losses),
    some torch releases refuse to turn one partial kind into the
    other."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def keep_batch(t, dim: int | None = None):
    """On a DTensor: its batch shard (dim 0) kept, and every other mesh
    dim resolved to a shard of ``dim`` where the product of their widths
    divides it, else to a replica; the identity on a plain tensor.  For
    the recurrences that walk the sequence (the SSD's chunk loop, the
    RG-LRU's scan): DTensor may leave their inputs sharded on the
    sequence or chunk dim, and each step's slice of it would gather the
    whole tensor; on the heads or channels dim every step is local."""
    if not isinstance(t, DTensor):
        return t
    mesh, pl = t.device_mesh, list(t.placements)
    rest = [i for i, p in enumerate(pl) if not (isinstance(p, Shard) and p.dim == 0)]
    ways = 1
    for i in rest:
        ways *= mesh.shape[i]
    target = Replicate()
    if dim is not None and ways > 1 and t.shape[dim] % ways == 0:
        target = Shard(dim % t.ndim)
    for i in rest:
        pl[i] = target
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def local_like(t, ref, dims: dict[int, int]):
    """``t``'s local shard placed as ``ref`` would place it: each mesh
    dim that shards ``ref`` on a dim of ``dims``' keys shards ``t`` on
    the mapped dim, every other mesh dim replicates it (a local slice of
    a replicated ``t``; a plain ``t`` counts as replicated).  For the
    ops that run on each rank's own shards."""
    mesh = ref.device_mesh
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in ref.placements]
    return (t if list(t.placements) == want else t.redistribute(mesh, want)).to_local()


def match_heads(t, ref):
    """(B, S, H, hd) ``t`` placed as ``ref`` on its batch and head dims,
    the identity unless both are DTensors.  Attention's K/V, repeated to
    the query heads, are often replicated where q is sharded on heads;
    GSPMD shards them to match without being told, DTensor would instead
    gather q's heads and compute every head's scores on each rank.
    Sharding a replicated dim is a local slice."""
    if not (isinstance(t, DTensor) and isinstance(ref, DTensor)):
        return t
    want = []
    for p, own in zip(ref.placements, t.placements):
        if isinstance(p, Shard) and p.dim in (0, 2):
            want.append(p)
        elif isinstance(own, Shard) and own.dim in (0, 2):
            want.append(Replicate())
        else:
            want.append(own)
    return t if tuple(want) == tuple(t.placements) else t.redistribute(t.device_mesh, want)


def merge_heads(t):
    """(B, S, H, hd) -> (B, S, H * hd): the plain ``reshape`` on a plain
    tensor or without grad.  On a DTensor under autograd whose head dim
    does not split over the mesh dims that replicate it, the merged dim
    is sharded on them after the reshape (a local slice): the gradient
    that comes back sharded on the merged dim (from an output projection
    split on its input dim) is then gathered before the reshape's
    backward, which cannot unflatten a shard that splits a head."""
    b, s, h = t.shape[0], t.shape[1], t.shape[2]
    out = t.reshape(b, s, -1)
    if not (isinstance(t, DTensor) and t.requires_grad):
        return out
    mesh, pl = out.device_mesh, list(out.placements)
    free = [i for i, p in enumerate(pl) if p == Replicate()]
    ways = 1
    for i in free:
        ways *= mesh.shape[i]
    if ways == 1 or h % ways == 0 or out.shape[2] % ways:
        return out
    for i in free:
        pl[i] = Shard(2)
    return out.redistribute(mesh, pl)


def split_heads(t, heads: int, head_dim: int):
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim): the plain
    ``reshape`` on a plain tensor.  On a DTensor, the mesh dims that
    shard the fused last dim or hold partial sums of it (DTensor may
    contract an FSDP weight's sharded input dim) are resolved first:
    to a shard of whole heads where the head count divides them (a
    reduce-scatter of partial sums), else replicated (an all-gather or
    all-reduce), as GSPMD reshards there."""
    b, s = t.shape[0], t.shape[1]
    if isinstance(t, DTensor):
        last = t.ndim - 1
        mesh, pl = t.device_mesh, list(t.placements)
        split = [i for i, p in enumerate(pl)
                 if (isinstance(p, Shard) and p.dim == last) or p.is_partial()]
        ways = 1
        for i in split:
            ways *= mesh.shape[i]
        want = Shard(last) if ways > 1 and heads % ways == 0 else Replicate()
        for i in split:
            pl[i] = want
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(b, s, heads, head_dim)
