"""Checkpointing with atomic writes and restart-from-latest (port of the
JAX package's ``train/checkpoint.py``, the same files on disk).

A checkpoint of step N is ``step_N.npz``, the tree flattened to
``/``-joined paths (dict keys, list, tuple and NamedTuple indices; a None
leaf, as graphcast's ``mesh_pos``, is an empty node and stores nothing,
as ``jax.tree`` treats it), with an
optional ``step_N.json`` of metadata. Each file is written to a temporary
name and renamed (a crash mid-write never corrupts the latest snapshot);
``latest_step`` finds the newest; retention keeps the newest ``keep``.
A checkpoint the JAX package writes loads here and the other way round.

Leaves are stored as numpy arrays: bfloat16 tensors as float32 (numpy
has no bfloat16; the widening is exact), which ``restore`` casts back.
``load_checkpoint`` returns numpy leaves, as the JAX function does;
``restore`` puts them on a template's devices and dtypes.
"""
from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch

from repro_torch.tree import tree_map


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = _host(tree)
    return out


def _unflatten(flat: dict, template):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(
            {kk[len(k) + 1:]: vv for kk, vv in flat.items()
             if kk.split("/")[0] == k}, v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        typ = type(template)
        items = [_unflatten(
            {kk[len(str(i)) + 1:]: vv for kk, vv in flat.items()
             if kk.split("/")[0] == str(i)}, v)
            for i, v in enumerate(template)]
        if hasattr(typ, "_fields"):        # NamedTuple
            return typ(*items)
        return typ(items)
    (val,) = flat.values()
    return val


def _write(ckpt_dir: str, step: int, flat: dict, keep: int,
           metadata: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, final)           # atomic
    if metadata is not None:
        mtmp = os.path.join(ckpt_dir, f".tmp_step_{step}.json")
        with open(mtmp, "w") as f:
            json.dump(metadata, f)
        os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step}.json"))
    _retain(ckpt_dir, keep)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3,
                    metadata: dict | None = None) -> str:
    return _write(ckpt_dir, step, _flatten(tree), keep, metadata)


def save_checkpoint_async(ckpt_dir: str, step: int, tree, keep: int = 3,
                          metadata: dict | None = None) -> threading.Thread:
    """Copies every leaf to the host before it returns (the caller may
    then update the tensors in place), then writes the files on a
    background thread; join the returned thread to wait for them."""
    flat = _flatten(tree)
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, flat, keep, metadata))
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, template, step: int | None = None):
    """(tree of numpy arrays shaped like ``template``, {"step",
    "metadata"}) of ``step`` (default: the latest), or (None, None)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta_path = os.path.join(ckpt_dir, f"step_{step}.json")
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return _unflatten(flat, template), {"step": step, "metadata": meta}


def restore(loaded, template):
    """The numpy tree of :func:`load_checkpoint` as tensors, each on its
    template leaf's device, in its dtype and shape."""
    return tree_map(lambda t, a: torch.from_numpy(np.asarray(a)).to(
        device=t.device, dtype=t.dtype).reshape(t.shape), template, loaded)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted([int(m.group(1)) for f in os.listdir(ckpt_dir)
                    if (m := re.fullmatch(r"step_(\d+)\.npz", f))])
    for s in steps[:-keep] if keep > 0 else []:
        for ext in (".npz", ".json"):
            p = os.path.join(ckpt_dir, f"step_{s}{ext}")
            if os.path.exists(p):
                os.remove(p)
