"""Parameter and optimizer-state trees: dicts, lists and NamedTuples of
tensors, walked in the JAX package's ``jax.tree_util`` order.

Dict keys go in sorted order, lists by index, a NamedTuple by field.  A
leaf's path names each step as ``checkpoint._flatten`` in the JAX package
does: a dict key as itself, a list index as its number, a NamedTuple field
with a leading ``.`` (the ``str`` of JAX's ``GetAttrKey``), so
``"/".join(path)`` is the JAX checkpoint's key (``groups/0/wq``,
``.mu/embed``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Path = Tuple[str, ...]


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree: Any, prefix: Path = ()
                      ) -> List[Tuple[Path, torch.Tensor]]:
    """Every tensor of ``tree`` with its path, in JAX's flattening
    order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        raise TypeError(f"not a tree of tensors: {type(tree).__name__} at "
                        f"{'/'.join(prefix)}")
    out: List[Tuple[Path, torch.Tensor]] = []
    for key, node in items:
        out += leaves_with_paths(node, prefix + (key,))
    return out


def leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in leaves_with_paths(tree)]


def map_with_path(fn: Callable[[Path, torch.Tensor], Any], tree: Any,
                  prefix: Path = ()) -> Any:
    """``tree`` with each tensor ``t`` at ``path`` replaced by ``fn(path,
    t)``; the containers keep their types."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tree of tensors: {type(tree).__name__} at "
                    f"{'/'.join(prefix)}")


def unflatten_like(tree: Any, flat: List[Any]) -> Any:
    """A tree shaped as ``tree`` holding ``flat``'s items in
    ``leaves_with_paths`` order."""
    index = {path: i for i, (path, _) in enumerate(leaves_with_paths(tree))}
    if len(index) != len(flat):
        raise ValueError(f"{len(flat)} items for a tree of {len(index)} "
                         f"leaves")
    return map_with_path(lambda path, _: flat[index[path]], tree)
