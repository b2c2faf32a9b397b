"""Frozen dataclasses registered as JAX pytrees.

`@pytree.dataclass` makes a frozen dataclass whose fields are pytree
leaves (or sub-trees), except fields declared with `static_field()`, which
travel as treedef metadata: they are hashed into the jit cache key and
never traced. Instances get `.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax

_STATIC = "pytree_static"


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves (jit-static)."""
    return dataclasses.field(metadata={_STATIC: True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get(_STATIC) else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
