"""Sharding rules: TP/EP over the ``model`` axis, DP over ``pod``+``data``,
optional FSDP (ZeRO-3 style parameter sharding over the data axes).

The port's copy of the reference's rules, leaf for leaf. They are
*divisibility-aware*: each parameter kind carries a priority list of
trailing dims to shard on the model axis; the first divisible dim wins, else
the leaf stays replicated on that axis. Stacked (scan) leaves keep their
leading period axis unsharded. FSDP then shards the largest remaining
divisible dim over the data axes for leaves of at least ``fsdp_min_size``
elements.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of axis names (the dim split over their product, the first axis
major). :func:`placements` turns it into one DTensor placement per mesh dim,
and :func:`shard_tree` places a tree of tensors by them. Trees are the
port's dicts and lists; a leaf's path names are its dict keys and list
indices (``str(i)``). Leaves that are not tensors (a cache's host-int
``pos``) get no spec (``None``) and are placed as they are.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.distributed.meshutil import axis_sizes

# trailing-dim shard priorities by parameter name (TP/EP on the model axis).
# Attention shards heads or nothing: non-divisible head counts fall back to
# FSDP only.
_RULES = {
    "embed": (0, 1),  # (vocab, d)
    "lm_head": (1, 0),  # (d, vocab)
    "wq": (1,), "wk": (1,), "wv": (1,),  # (d, H, hd): heads only
    "wo": (0,),  # (H, hd, d) row-parallel over heads
    "w1": (1,), "w3": (1,),  # mlp (d, f) col-parallel
    "w2": (0,),  # mlp (f, d) row-parallel
    "router": (1,),  # (d, E)
    "z_proj": (1,), "x_in": (1,), "xbc_proj": (1,), "dtp": (1,),  # mamba cols
    "out_proj": (0,),
    "x_proj": (0,), "dt_proj": (1,),
    "A_log": (0,), "Dskip": (0,), "dt_bias": (0,),
    "conv_w": (1,), "conv_b": (0,),
}
_MOE_RULES = {"w1": (0,), "w2": (0,), "w3": (0,)}  # (E, d, f): expert parallelism

# weight names that lose their model-axis (TP) assignment when a config opts
# its SSM layers out of tensor parallelism (ModelConfig.ssm_tp=False)
SSM_WEIGHT_NAMES = frozenset({
    "x_in", "z_proj", "bc_proj", "dtp", "out_proj", "x_proj", "dt_proj",
    "conv_w", "conv_b", "conv_bc_w", "conv_bc_b", "A_log", "Dskip", "dt_bias",
})


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path names, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def _spec_for_leaf(names, shape, mesh, model_axis, fsdp_axes, fsdp_min_size,
                   no_tp_names=frozenset()) -> tuple:
    name = names[-1]
    stacked = "slots" in names  # scan-stage leaves carry a leading period axis
    dims = list(shape[1:] if stacked else shape)
    assign: list = [None] * len(dims)

    in_moe = "moe" in names
    rules = _MOE_RULES if (in_moe and name in _MOE_RULES) else _RULES
    msize = _axis_size(mesh, model_axis)
    if name not in no_tp_names:
        for d in rules.get(name, ()):
            if d < len(dims) and dims[d] % msize == 0 and dims[d] >= msize:
                assign[d] = model_axis
                break

    # FSDP: shard the largest remaining divisible dim over the data axes.
    # The size gate counts the whole leaf, the stacked period axis included:
    # memory is what matters, and scan stages stack 24-88 layers into one leaf.
    if fsdp_axes and len(dims) >= 2:
        size = 1
        for s in shape:
            size *= s
        if size >= fsdp_min_size:
            fsize = _axis_size(mesh, fsdp_axes)
            cands = sorted((i for i in range(len(dims)) if assign[i] is None),
                           key=lambda i: -dims[i])
            for i in cands:
                if dims[i] % fsize == 0 and dims[i] >= fsize:
                    assign[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                    break
    if stacked:
        assign = [None] + assign
    return tuple(assign)


def param_specs(params, mesh, *, model_axis: str = "model",
                fsdp_axes: tuple[str, ...] = (), fsdp_min_size: int = 1 << 24,
                no_tp_names: frozenset = frozenset()):
    """The spec tree of a parameter (or optimizer-moment) tree."""
    return _map_with_path(
        lambda names, leaf: _spec_for_leaf(names, tuple(leaf.shape), mesh, model_axis,
                                           fsdp_axes, fsdp_min_size, no_tp_names),
        params)


def batch_specs(batch, mesh, *, dp_axes: tuple[str, ...]):
    """Dim 0 (the global batch) of every batch leaf over the DP axes, where
    it divides; else the leaf is replicated."""
    dsize = _axis_size(mesh, dp_axes)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def leaf_spec(_, leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % dsize == 0 and leaf.shape[0] >= dsize:
            return (dp,) + (None,) * (leaf.ndim - 1)
        return (None,) * leaf.ndim

    return _map_with_path(leaf_spec, batch)


def cache_specs(cache, mesh, *, model_axis: str = "model",
                dp_axes: tuple[str, ...] = ("data",)):
    """Decode-cache specs: batch over DP; long KV sequence / SSM channels
    over model.

    KV leaves are (B, S, K, hd) (+ leading stack axis); SSM ``h`` is
    (B, nh|di, N[, hp]); conv states (B, K-1, C). The dim choice is
    divisibility-gated, so batch-1 long-context cells degrade gracefully.
    ``pos``, a host int here, gets no spec.
    """
    dsize = _axis_size(mesh, dp_axes)
    msize = _axis_size(mesh, model_axis)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def leaf_spec(names, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        name = names[-1]
        stacked = "slots" in names
        dims = list(leaf.shape[1:] if stacked else leaf.shape)
        assign: list = [None] * len(dims)
        if not dims:
            return (None,) * leaf.ndim
        if dims[0] % dsize == 0 and dims[0] >= dsize:
            assign[0] = dp  # batch
        if name in ("k", "v") and len(dims) == 4:
            if dims[1] % msize == 0:  # cache sequence dim (decode SP)
                assign[1] = model_axis
            elif dims[2] % msize == 0:  # kv heads
                assign[2] = model_axis
        elif name in ("h", "conv") and len(dims) >= 2:
            for d in (1, 2):
                if d < len(dims) and dims[d] % msize == 0 and dims[d] >= msize:
                    assign[d] = model_axis
                    break
        if stacked:
            assign = [None] + assign
        return tuple(assign)

    return _map_with_path(leaf_spec, cache)


def placements(spec, mesh) -> list:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
    ``d``'s entry names that mesh axis, else ``Replicate()``. A dim over
    several axes is ``Shard(d)`` on each; DTensor splits it by the earlier
    mesh dim first, which is the reference's major-first order as long as
    the entry lists its axes in the mesh's order (checked)."""
    names = tuple(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} must follow the "
                             f"mesh's order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape each rank holds of a ``shape`` leaf placed by ``spec``
    (every sharded dim divides, as the rules make it)."""
    return tuple(s // _axis_size(mesh, e) for s, e in zip(shape, spec))


def shard_tree(tree, specs, mesh, device=None):
    """``tree`` placed by ``specs`` on ``mesh``. A DTensor leaf is
    redistributed (a no-op when it is placed so already); any other array
    leaf is moved to ``device`` (if given) and each rank slices its own part
    of it (``src_data_rank=None``): no communication, so every rank must
    hold the same full values. Leaves without a spec are kept."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s, mesh, device) for v, s in zip(tree, specs, strict=True)]
    if specs is None:
        return tree
    pl = placements(specs, mesh)
    if isinstance(tree, DTensor):
        return tree if list(tree.placements) == pl else tree.redistribute(mesh, pl)
    t = torch.as_tensor(tree)
    return distribute_tensor(t if device is None else t.to(device), mesh, pl,
                             src_data_rank=None)
