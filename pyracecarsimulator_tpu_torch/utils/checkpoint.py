"""Checkpoint / resume as NumPy ``.npz`` files.

Counterpart of ``pyracecarsimulator_tpu/utils/checkpoint.py`` (its npz
half; Orbax is JAX-side and not ported). The file layouts are the JAX
package's, so a checkpoint written by either package loads in the other:
``save_npz`` stores a ``CarState`` by field name; ``save_pytree`` stores the
leaves of a tree of dicts, lists and tuples in ``jax.tree.leaves`` order
(dict keys sorted), which is how trained policy parameters cross over.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..state import CarState, FIELDS, state_from_numpy


def save_npz(path: str, state: CarState, key=None, step: int = 0) -> None:
    """Save a state, an optional ``key`` array (for example a generator's
    ``get_state()``) and a step counter, atomically."""
    arrays = {f"state_{k}": v for k, v in state.numpy().items()}
    if key is not None:
        arrays["key"] = np.asarray(key)
    arrays["step"] = np.asarray(step)
    tmp = path + ".tmp.npz"      # savez keeps the name when it ends in .npz
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_npz(path: str, device="cpu") -> Tuple[CarState, Optional[Any], int]:
    """Returns (state on ``device``, key as a CPU tensor or None, step)."""
    with np.load(path) as z:
        state = state_from_numpy({k: z[f"state_{k}"] for k in FIELDS},
                                 device=device)
        key = torch.from_numpy(z["key"].copy()) if "key" in z else None
        step = int(z["step"])
    return state, key, step


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in _leaves(t)]
    return [tree]


def _unflatten(template, leaves):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    leaf = next(leaves)
    if torch.is_tensor(template):
        return torch.as_tensor(leaf, device=template.device)
    return leaf


def save_pytree(path: str, tree: Any) -> None:
    """Save the leaves of a tree of dicts, lists and tuples (tensors,
    arrays or numbers) as a ``.npz``; the structure is not stored."""
    leaves = _leaves(tree)
    to_np = lambda l: (l.detach().cpu().numpy() if torch.is_tensor(l)
                       else np.asarray(l))
    np.savez(path if path.endswith(".npz") else path + ".npz",
             n=np.asarray(len(leaves)),
             **{f"leaf_{i}": to_np(l) for i, l in enumerate(leaves)})


def load_pytree(path: str, template: Any) -> Any:
    """Restore a tree saved by ``save_pytree`` (either package's) into the
    structure of ``template``; tensor leaves come back as tensors on the
    template leaf's device, others as NumPy arrays. The leaf count is
    checked."""
    p = path if path.endswith(".npz") else path + ".npz"
    n_t = len(_leaves(template))
    with np.load(p) as z:
        n = int(z["n"])
        if n != n_t:
            raise ValueError(f"checkpoint holds {n} leaves but the template "
                             f"has {n_t}")
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return _unflatten(template, iter(leaves))
