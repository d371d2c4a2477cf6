"""Frozen dataclasses registered as JAX pytrees.

``class X(PyTreeNode)`` makes ``X`` a frozen dataclass whose fields are
pytree leaves, except those declared with ``field(pytree_node=False)``,
which are static metadata: hashed into the tree structure, so they
specialize every ``jax.jit`` trace. ``x.replace(**changes)`` returns a
copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: every subclass becomes a frozen, registered dataclass."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if f.metadata.get("pytree_node", True)],
            meta_fields=[f.name for f in fields
                         if not f.metadata.get("pytree_node", True)])

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
