"""Checkpoints: atomic commit, resume, garbage collection.

The reference's on-disk format, file for file:

    <root>/step_000000123.tmp/   written fully first
    <root>/step_000000123/       the rename marks the commit
    <root>/LATEST                the last committed step (written through
                                 LATEST.tmp and os.replace)

Each step directory holds ``params.npz`` and ``opt_state.npz``, flat and
keyed by the tree path (``embed``, ``stages/0/slots/1/attn/wq``,
``m/stages/...``, ``step``), and ``manifest.json`` (the step and the
caller's metadata). bfloat16 leaves are stored as float32 (exact) and cast
back to the example leaf's dtype on restore, so either package restores the
other's checkpoints bit for bit. ``restore(..., device=)`` places the
tensors where the reference's ``shardings=`` placed its arrays.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _key(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def _paths(tree, prefix: str = ""):
    """``(path, leaf)`` for every tensor of a tree of dicts and lists, the
    path spelled as the reference spells it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, _key(prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, _key(prefix, i))
    else:
        yield prefix, tree


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _paths(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()  # npz holds no bfloat16; restore casts back (exact)
        flat[key] = t.numpy()
    return flat


def _restore(tree, stored, device, prefix: str = ""):
    """``tree`` with every leaf replaced by the stored array of its path, in
    the example leaf's dtype, on ``device`` (the example leaf's when None)."""
    if isinstance(tree, dict):
        return {k: _restore(v, stored, device, _key(prefix, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_restore(v, stored, device, _key(prefix, i)) for i, v in enumerate(tree)]
    arr = stored[prefix]
    if tuple(arr.shape) != tuple(tree.shape):
        raise ValueError(f"{prefix}: stored shape {arr.shape} != {tuple(tree.shape)}")
    return torch.from_numpy(arr).to(device=tree.device if device is None else device,
                                    dtype=tree.dtype)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def save(self, step: int, params, opt_state, meta: dict | None = None) -> str:
        tmp = self._dir(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
        np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        final = self._dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.root, "LATEST.tmp"), os.path.join(self.root, "LATEST"))
        self._gc()
        return final

    def latest_step(self) -> int | None:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            step = int(f.read().strip())
        return step if os.path.exists(self._dir(step)) else None

    def restore(self, step: int, example_params, example_opt, *, device=None):
        """``(params, opt_state, manifest)`` of a committed step, each leaf in
        its example leaf's dtype, on ``device`` (each example leaf's own
        device when None)."""
        d = self._dir(step)
        with np.load(os.path.join(d, "params.npz")) as z:  # one array at a time
            params = _restore(example_params, z, device)
        with np.load(os.path.join(d, "opt_state.npz")) as z:
            opt = _restore(example_opt, z, device)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return params, opt, manifest

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
