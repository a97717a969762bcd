"""Checkpointing (the port's copy of `repro/checkpoint/ckpt.py`), with the
reference's on-disk layout: a state tree flattened to key paths, stored as
one ``ckpt_<step>.npz`` (``/`` in a path written as ``__``) plus a JSON
manifest of the step and the keys.

The port's train state holds its model as a `TransformerLM` module; a
module in a tree flattens to its parameters under the reference's paths
(``params/blocks/attn/wq``, the stacked [L, ...] leaf), so a checkpoint the
reference wrote restores into the port and back, optimizer state included.
bf16 leaves are stored as float32 (numpy has no bfloat16).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.utils import get_logger, module_tree, tree_flatten_with_paths

log = get_logger("repro_torch.ckpt")


def _expand(tree: Any) -> Any:
    """The tree with every module replaced by its parameter tree."""
    if hasattr(tree, "named_parameters") and callable(tree.named_parameters):
        return module_tree(tree)
    if isinstance(tree, dict):
        return {k: _expand(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_expand(x) for x in tree)
    return tree


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in tree_flatten_with_paths(_expand(tree))}


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *, keep: int = 3) -> str:
    """Write ``state`` as ``ckpt_<step>.npz`` and its manifest, then keep the
    newest ``keep`` checkpoints.  Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(state).items()}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    np.savez(path, **{k.replace("/", "__"): v for k, v in arrays.items()})
    manifest = {"step": step, "keys": sorted(arrays),
                "treedef": "port: " + ", ".join(sorted(arrays))}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    _gc(ckpt_dir, keep)
    log.info("saved checkpoint %s (%d leaves)", path, len(arrays))
    return path


def _gc(ckpt_dir: str, keep: int):
    ckpts = sorted(
        f for f in os.listdir(ckpt_dir) if re.fullmatch(r"ckpt_\d+\.npz", f)
    )
    for old in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
        meta = os.path.join(ckpt_dir, old + ".json")
        if os.path.exists(meta):
            os.remove(meta)


def load_checkpoint(path: str, target: Any) -> Any:
    """Restore into the structure of ``target``: each leaf a new tensor of
    the target leaf's dtype and device (a leaf that is not a tensor, an
    array).  A module in ``target`` is restored in place, its parameters
    copied into, and stands in the result as itself."""
    data = np.load(path)

    def restore(key, ref):
        arr = data[key.replace("/", "__")]
        assert arr.shape == tuple(ref.shape), (key, arr.shape, tuple(ref.shape))
        if isinstance(ref, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(
                dtype=ref.dtype, device=ref.device)
        return np.asarray(arr, dtype=ref.dtype)

    def walk(node, prefix):
        if hasattr(node, "named_parameters") and callable(node.named_parameters):
            with torch.no_grad():
                for name, p in node.named_parameters():
                    key = "/".join(prefix + name.split("."))
                    p.copy_(restore(key, p))
            return node
        if isinstance(node, dict):
            return {k: walk(v, prefix + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x, prefix + [str(i)]) for i, x in enumerate(node))
        return None if node is None else restore("/".join(prefix), node)

    return walk(target, [])


def restore_latest(ckpt_dir: str, target: Any):
    """Returns (state, step) or (None, -1)."""
    if not os.path.isdir(ckpt_dir):
        return None, -1
    ckpts = sorted(
        f for f in os.listdir(ckpt_dir) if re.fullmatch(r"ckpt_\d+\.npz", f)
    )
    if not ckpts:
        return None, -1
    path = os.path.join(ckpt_dir, ckpts[-1])
    step = int(re.findall(r"\d+", ckpts[-1])[0])
    return load_checkpoint(path, target), step


__all__ = ["load_checkpoint", "restore_latest", "save_checkpoint"]
