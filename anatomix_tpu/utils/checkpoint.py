"""Pytree checkpointing: flat .npz (portable, torch-free) + Orbax wrappers.

Fills the reference's checkpoint roles (SURVEY.md §5.4): weights, full train
state (params + optimizer state + step), and best-val tracking.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__len__"] = np.asarray(
            [len(tree), 1 if isinstance(tree, tuple) else 0]
        )
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    elif tree is None:
        out[f"{prefix}__none__"] = np.asarray(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    # group keys by first path component
    if list(flat.keys()) == [""]:
        return flat[""]
    groups: dict[str, dict] = {}
    scalars: dict[str, np.ndarray] = {}
    for key, val in flat.items():
        if "/" in key:
            head, rest = key.split("/", 1)
            groups.setdefault(head, {})[rest] = val
        else:
            scalars[key] = val
    if "__len__" in scalars or any(k.startswith("[") for k in groups):
        meta = scalars.get("__len__")
        n = int(meta[0]) if meta is not None else len(groups)
        as_tuple = bool(meta[1]) if meta is not None else False
        items = [_unflatten(groups[f"[{i}]"]) for i in range(n)]
        return tuple(items) if as_tuple else items
    if "__none__" in scalars:
        return None
    out: dict[str, Any] = {}
    for k, v in scalars.items():
        out[k] = v
    for k, sub in groups.items():
        out[k] = _unflatten(sub)
    return out


def save_pytree(path: str, tree: Any) -> None:
    """Save a pytree of arrays (dicts/lists/tuples/None leaves) to .npz."""
    host_tree = jax.tree_util.tree_map(np.asarray, tree)
    np.savez(path, **_flatten(host_tree))


def load_pytree(path: str) -> Any:
    z = np.load(path, allow_pickle=False)
    return _unflatten({k: z[k] for k in z.files})


def save_state_leaves(path: str, state: Any) -> None:
    """Save an arbitrary pytree (incl. optax NamedTuple states and
    registered dataclasses) as its ordered leaves; restore with `load_state_leaves`
    against a structurally-identical template."""
    leaves = jax.tree_util.tree_leaves(state)
    np.savez(path, **{f"leaf_{i}": np.asarray(l) for i, l in
                      enumerate(leaves)})


def load_state_leaves(path: str, template: Any) -> Any:
    z = np.load(path, allow_pickle=False)
    leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    treedef = jax.tree_util.tree_structure(template)
    t_leaves = jax.tree_util.tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"Checkpoint has {len(leaves)} leaves; template expects "
            f"{len(t_leaves)} (architecture/optimizer mismatch)."
        )
    restored = [
        np.asarray(l).reshape(np.shape(t)).astype(np.asarray(t).dtype)
        if np.shape(l) != np.shape(t) else l
        for l, t in zip(leaves, t_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, restored)


def save_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def latest_checkpoint(ckpt_dir: str, prefix: str = "epoch") -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [
        f for f in os.listdir(ckpt_dir)
        if f.startswith(prefix) and f.endswith(".npz")
    ]
    if not cands:
        return None
    return os.path.join(ckpt_dir, sorted(cands)[-1])
