"""Frozen dataclasses registered as JAX pytrees.

``pytree_node`` turns a class into a frozen dataclass whose fields are
pytree leaves, except those declared with ``static_field()``, which become
static (hashable) aux data. Instances get ``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves (static aux data)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_node(cls):
    """Frozen dataclass + pytree registration (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
