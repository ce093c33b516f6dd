"""Model summaries (port of ``audiosourcesep_tpu/utils/summary.py``).

``params`` is an ``nn.Module`` (its trainable parameters, nested by its
child modules as the JAX params pytree nests them) or a nested mapping or
sequence of tensors or arrays (a JAX-layout params tree).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tree(params: Any) -> Any:
    """The nested params of a module, as the JAX package nests them: a
    dict per child module, a module without parameters an empty leaf."""
    if not isinstance(params, torch.nn.Module):
        return params
    tree = {name: p for name, p in params.named_parameters(recurse=False)
            if p.requires_grad}
    for name, child in params.named_children():
        sub = _tree(child)
        tree[name] = sub if _count(sub) or not isinstance(sub, dict) else ()
    return tree


def _count(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count(v) for v in tree)
    return int(np.prod(np.shape(tree)))


def total_trainable_variables(params: Any) -> int:
    return _count(_tree(params))


def print_summary(params: Any, max_depth: int = 2) -> None:
    """Print per-subtree parameter counts down to ``max_depth``."""
    def walk(tree, prefix, depth):
        if depth >= max_depth or not isinstance(tree, dict):
            print(f"{'  ' * depth}{prefix}: {_count(tree):,}")
            return
        print(f"{'  ' * depth}{prefix}:")
        for k in tree:
            walk(tree[k], k, depth + 1)

    tree = _tree(params)
    walk(tree, "model", 0)
    print(f"Total Trainable Variables: {_count(tree):,}")
