"""Logical activation sharding constraints (the reference's MaxText-style
``constrain``), applied as DTensor redistributions.

Model code tags each activation dim with a *logical* role; the tag resolves
against the ambient mesh (``meshutil.set_mesh``) when the code runs:

  "dp"    -> every non-model axis (pod+data), if the dim divides
  "dpm"   -> every axis, if the dim divides; else "dp"'s rule
  "model" -> the model axis, if the dim divides
  None    -> replicated

The resulting spec becomes placements (``sharding.placements``) and
``DTensor.redistribute`` moves the tensor there (differentiable: the
gradient goes back to the placements it came from). Without an ambient
mesh, or on a mesh without a ``"model"`` axis, ``constrain`` returns its
input itself, so model code stays mesh-agnostic. Under a mesh every tagged
activation must be a DTensor: a plain tensor there means some input was
never placed, and ``constrain`` says so.

Two helpers serve the model code on a mesh:

* :func:`replicated` lifts a tensor built inside a forward (positions,
  masks, rotary tables, zero states) to a replicated DTensor on the mesh of
  the activation it meets, and returns it as it is without a mesh. This is
  the port's one rule for plain tensors meeting DTensors; DTensor's
  ``implicit_replication`` is not used (its switch is thread-local, and
  CUDA runs a backward on autograd's own thread).
* :func:`local` runs a function on the local shards of DTensors placed as
  the caller asks, and wraps its results back with the placements it
  names: for regions DTensor has no sharding rule for (the MoE dispatch,
  the embedding lookup, the decode cache write), or where the tags make the
  work local.
* :func:`einsum` is ``torch.einsum`` that, on DTensors, runs on the local
  shards: each index is split as the operands split it (an operand that
  leaves it whole is sliced to match, no communication), and an index
  summed over a split is all-reduced over those mesh dims (a row-parallel
  product's reduction). DTensor's own einsum flattens the batch dims into
  one, which it refuses when two of them are split (the batch on the data
  axes, heads on ``model``), and its product rules may gather a weight
  where the split activation could stay split. :func:`matmul` is ``x @ w``
  for a 2-D ``w`` through it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.meshutil import axis_sizes, get_mesh
from repro_torch.distributed.sharding import placements


def tag_spec(shape, tags, mesh) -> tuple:
    """The spec ``constrain`` gives a tensor of ``shape`` tagged ``tags`` on
    ``mesh`` (a ``DeviceMesh`` or a shape-only stand-in): one entry per dim,
    ``None``, an axis name or a tuple of axis names."""
    sizes = axis_sizes(mesh)
    msize = sizes["model"]
    dp = tuple(a for a in sizes if a != "model")
    all_axes = tuple(sizes)
    dsize = 1
    for a in dp:
        dsize *= sizes[a]
    asize = dsize * msize
    dp_entry = dp if len(dp) > 1 else dp[0]
    assign = []
    for dim, tag in zip(shape, tags):
        if tag == "dp" and dim % dsize == 0 and dim >= dsize:
            assign.append(dp_entry)
        elif tag == "dpm" and dim % asize == 0 and dim >= asize:
            assign.append(all_axes)
        elif tag == "dpm" and dim % dsize == 0 and dim >= dsize:
            assign.append(dp_entry)  # fall back to dp
        elif tag == "model" and dim % msize == 0 and dim >= msize:
            assign.append("model")
        else:
            assign.append(None)
    return tuple(assign)


def constrain(x: torch.Tensor, *tags: str | None) -> torch.Tensor:
    """Tags: "dp" (non-model axes), "model", "dpm" (every axis: a fully
    data-parallel batch, for a layer family that opts out of TP), None."""
    mesh = get_mesh()
    if mesh is None or "model" not in axis_sizes(mesh):
        return x
    if len(tags) != x.ndim:
        raise ValueError(f"constrain: {len(tags)} tags {tags} for a tensor of shape "
                         f"{tuple(x.shape)}")
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain under a mesh got a plain tensor of shape "
                        f"{tuple(x.shape)} (tags {tags}): an input was not placed on the mesh")
    return x.redistribute(mesh, placements(tag_spec(x.shape, tags, mesh), mesh))


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same full value on every rank) as a replicated DTensor on
    ``like``'s mesh when ``like`` is a DTensor; else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank; other tensors as they are."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def spec_of(t: torch.Tensor) -> tuple | None:
    """The spec of a DTensor's placements (``None`` for a plain tensor)."""
    if not isinstance(t, DTensor):
        return None
    entries: list = [[] for _ in range(t.ndim)]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if p.is_partial():
            raise ValueError(f"a partial DTensor of shape {tuple(t.shape)} has no spec")
        if p.is_shard():
            entries[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries)


def local(fn, args, in_specs, out_specs):
    """``fn`` on local shards. With no DTensor among ``args`` it is
    ``fn(*args)``. Otherwise each DTensor argument is redistributed to its
    spec in ``in_specs`` (``None``: taken as it is) and passed as its local
    tensor, other arguments as they are; the result of ``fn`` becomes a
    DTensor placed by ``out_specs`` (a spec: a tuple of ``sharding``'s
    entries), or, when ``out_specs`` is a list of specs, each of the tuple
    of results ``fn`` returns by its own. Differentiable both ways:
    an argument whole on a mesh dim over which the results are split gets a
    partial gradient there (each rank's share, summed)."""
    dts = [a for a in args if isinstance(a, DTensor)]
    single = not isinstance(out_specs, list)
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    outs_pl = [placements(s, mesh) for s in ((out_specs,) if single else out_specs)]
    split = [any(pl[i].is_shard() for pl in outs_pl) for i in range(mesh.ndim)]
    if any(s and not all(pl[i].is_shard() for pl in outs_pl) for i, s in enumerate(split)):
        raise ValueError(f"local: results {out_specs} are split on some mesh dims, whole on others")
    local_args = []
    for a, spec in zip(args, in_specs, strict=True):
        if isinstance(a, DTensor):
            if spec is not None:
                a = a.redistribute(mesh, placements(spec, mesh))
            grad = [Partial() if split[i] and pl.is_replicate() else pl
                    for i, pl in enumerate(a.placements)]
            a = a.to_local(grad_placements=grad)
        local_args.append(a)
    out = fn(*local_args)
    outs = (out,) if single else out
    wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                    for o, pl in zip(outs, outs_pl, strict=True))
    return wrapped[0] if single else wrapped


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``; on DTensors, computed on the local shards
    (see the module docstring). Partial operands are reduced first; an
    operand whole on a mesh dim over which the result is split gets a
    partial gradient there; a summed split index is all-reduced."""
    dts = [o for o in ops if isinstance(o, DTensor)]
    if not dts:
        return torch.einsum(eq, *ops)
    mesh = dts[0].device_mesh
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    ops = [replicated(o, dts[0]) for o in ops]
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    split: dict[str, list[int]] = {}  # index -> the mesh dims splitting it
    for letters, o in zip(ins, ops):
        for i, p in enumerate(o.placements):
            # a mesh dim of size 1 splits nothing: left whole, the same storage
            if p.is_shard() and mesh.size(i) > 1 and all(i not in v for v in split.values()):
                split.setdefault(letters[p.dim], []).append(i)
    result_pl: list = [Replicate()] * mesh.ndim
    for ch, dims in split.items():
        for i in dims:
            result_pl[i] = Shard(out.index(ch)) if ch in out else Partial()
    local_ops = []
    for letters, o in zip(ins, ops):
        want = [Replicate()] * mesh.ndim
        for d, ch in enumerate(letters):
            for i in split.get(ch, ()):
                want[i] = Shard(d)
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        grad = [Partial() if w.is_replicate() and not r.is_replicate() else w
                for w, r in zip(want, result_pl)]
        local_ops.append(o.to_local(grad_placements=grad))
    result = torch.einsum(f"{','.join(ins)}->{out}", *local_ops)
    result = DTensor.from_local(result, mesh, result_pl, run_check=False)
    if any(p.is_partial() for p in result_pl):
        result = result.redistribute(mesh, [Replicate() if p.is_partial() else p
                                            for p in result_pl])
    return result


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``; on DTensors through :func:`einsum`."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    lead = "abcdefgh"[:x.ndim - 1]
    return einsum(f"{lead}x,xy->{lead}y", x, w)
