"""Frozen dataclasses registered as JAX pytrees.

``@pytree.dataclass`` makes a frozen ``dataclasses.dataclass`` whose fields
are pytree children, except those declared with ``static_field()``, which
ride in the treedef (hashable metadata, invisible to ``jit`` tracing).
Instances get a ``replace(**changes)`` method returning an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    """Return a copy with the given fields replaced."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
