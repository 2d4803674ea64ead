"""State checkpoints: save and restore an app state with its step.

Port of mundy_tpu/io/checkpoint.py (the role of the reference's Exodus
restart path, `IOBroker.hpp:97-140,240-252`, and the HP1 driver's
`enable_continuation_if_available`, `:897-899`). The port's states are
trees of frozen dataclasses, NamedTuples, tuples, dicts, tensors and python
ints (the key words, `step`, `rebuild_count`); a checkpoint is one npz of
the leaves keyed by their field paths (`<index>|<path>`) plus a JSON
sidecar, published atomically. Fields marked `static_field` (grid
dimensions and capacities) are not leaves: like the reference's treedef
they come from the template state, so loading needs one (the sim's
`init()`), and a leaf whose shape a regrow changed fails the shape check,
as in the reference. The reference's migration of old chromatin layouts
has no counterpart here: the port never wrote those layouts.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

_SCALARS = (bool, int, float)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(name, child) pairs of an inner node of a state tree; None for a
    leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)
                if not f.metadata.get("mundy_static")]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if node is None or isinstance(node, (torch.Tensor,) + _SCALARS):
        return None
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _leaves(node, path=()):
    """[(path string, leaf)] in a fixed walk order (None holds nothing)."""
    kids = _children(node)
    if kids is None:
        return [] if node is None else [("/".join(path), node)]
    out = []
    for name, child in kids:
        out += _leaves(child, path + (name,))
    return out


def _rebuild(node, values):
    """The template `node` with its leaves taken from the iterator `values`."""
    kids = _children(node)
    if kids is None:
        return None if node is None else next(values)
    new = [_rebuild(child, values) for _, child in kids]
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{name: v for (name, _), v in zip(kids, new)})
    if _is_namedtuple(node):
        return type(node)(*new)
    if isinstance(node, (tuple, list)):
        return type(node)(new)
    return {k: v for (k, _), v in zip(kids, new)}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, state: Any,
                    metadata: Optional[dict] = None) -> str:
    """Write `<dir>/ckpt_<step:012d>.npz` (+ a JSON sidecar). Returns the path."""
    os.makedirs(directory, exist_ok=True)
    leaves = _leaves(state)
    arrays = {f"{i:04d}|{key}": _host(leaf) for i, (key, leaf) in enumerate(leaves)}
    path_npz = os.path.join(directory, f"ckpt_{step:012d}.npz")
    tmp = path_npz + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path_npz)  # atomic publish (crash-safe restart files)
    meta = {"step": int(step), "num_leaves": len(leaves)}
    if metadata:
        meta.update(metadata)
    with open(os.path.join(directory, f"ckpt_{step:012d}.json"), "w") as f:
        json.dump(meta, f)
    return path_npz


def _restore(name: str, arr: np.ndarray, ref):
    """`arr` as the template leaf `ref` holds it: its shape checked, cast to
    its dtype, on its device (a python scalar for a python scalar)."""
    shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
    if arr.shape != shape:
        raise ValueError(f"leaf {name}: shape {arr.shape} != template {shape}")
    if isinstance(ref, torch.Tensor):
        dtype = torch.zeros((), dtype=ref.dtype).numpy().dtype
        return torch.from_numpy(np.array(arr, dtype=dtype)).to(ref.device)
    return type(ref)(arr.item())


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a checkpoint into the structure of `template`, leaf by leaf
    (shapes validated, dtypes and devices the template's). Leaves match by
    order; when the counts disagree (the state's layout changed since the
    checkpoint was written) they match by field path before failing."""
    pleaves = _leaves(template)

    def finish(triples):
        loaded = [_restore(name, arr, ref) for name, arr, ref in triples]
        return _rebuild(template, iter(loaded))

    with np.load(path) as data:
        keys = sorted(data.files, key=lambda k: int(k.split("|")[0]))
        order_err = None
        if len(keys) == len(pleaves):
            try:
                return finish([(k, data[k], ref) for k, (_, ref) in zip(keys, pleaves)])
            except ValueError as e:  # the layout changed at an equal leaf count
                order_err = e
        by_name = {k.split("|", 1)[1]: data[k] for k in keys}
        tkeys = [name for name, _ in pleaves]
        if len(set(tkeys)) == len(tkeys) and all(t in by_name for t in tkeys):
            return finish([(t, by_name[t], ref) for t, (_, ref) in zip(tkeys, pleaves)])
        if order_err is not None:
            raise order_err
        raise ValueError(
            f"checkpoint has {len(keys)} leaves, template has {len(pleaves)} (the "
            "state's layout changed since this checkpoint was written)")


def latest_checkpoint(directory: str) -> Optional[str]:
    """The most recent checkpoint's path, or None (the continuation path)."""
    cands = glob.glob(os.path.join(directory, "ckpt_*.npz"))
    if not cands:
        return None

    def step_of(p):
        m = re.search(r"ckpt_(\d+)\.npz$", p)
        return int(m.group(1)) if m else -1

    return max(cands, key=step_of)
