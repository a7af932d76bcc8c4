"""``ParamTree``: a nested dict of weight tensors held by an ``nn.Module``.

The port keeps the JAX package's parameter layout (``[in, out]`` weights,
per-layer tensors stacked on a leading ``[L, ...]`` axis, quantized
weights as ``{"q8"|"q4", "scale"}`` dicts) so that the weight bridge is a
rename. The modules hold that tree as buffers, which ``state_dict``,
``.to`` and ``named_buffers`` see, and hand it back as the plain dict the
functional forward passes take. ``map_with_path``, ``leaves_with_path``
and ``tree_map`` walk such trees (the trainer's masks, gradients and
optimizer state).
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
from torch import nn

Tree = Union[Dict[str, Any], List[Any], torch.Tensor]


class ParamTree(nn.Module):
    """Buffers for the tensors of a nested dict/list tree (weights are not
    trained in the serving slice, so they are buffers, not parameters)."""

    def __init__(self, tree: Tree) -> None:
        super().__init__()
        self._kind = "list" if isinstance(tree, list) else "dict"
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        self._keys = []
        for key, val in items:
            name = f"item{key}" if self._kind == "list" else key
            self._keys.append(name)
            if isinstance(val, (dict, list)):
                self.add_module(name, ParamTree(val))
            else:
                self.register_buffer(name, val)

    def tree(self) -> Tree:
        """The held tensors as the nested dict/list they came from."""
        vals = []
        for name in self._keys:
            val = getattr(self, name)
            vals.append(val.tree() if isinstance(val, ParamTree) else val)
        if self._kind == "list":
            return vals
        return dict(zip(self._keys, vals))


def map_with_path(fn, tree: Tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree, rebuilt with the
    same structure; paths join keys and list indices with "/"
    ("projector/layers/0/kernel"), as the JAX package names leaves."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves_with_path(tree: Tree, path: str = ""):
    """[(path, leaf)] in the order ``map_with_path`` visits them."""
    out = []
    map_with_path(lambda p, leaf: out.append((p, leaf)), tree, path)
    return out


def tree_map(fn, tree: Tree, *rest: Tree):
    """``fn(leaf, *leaves)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
