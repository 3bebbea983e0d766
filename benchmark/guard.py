"""What the benchmark must never load: the JAX package beside the port and JAX itself.

Module names are compared by their top-level name, the part before the first dot, whole:
`atvsnet_torch` is the port and is allowed; `atvsnet_tpu` is not, whatever the two share
in their spelling."""

from __future__ import annotations

import ast
import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "atvsnet_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(banned=BANNED, modules=None) -> list:
    """Sorted top-level names in sys.modules (or `modules`) that are banned."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & set(banned))


def imports_of(source: str) -> set:
    """Top-level module names that a Python source imports, absolute imports only (a
    relative import stays inside its own package)."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out
