"""Example pipelines: ``maxint`` (a registered Func), ``urls`` and
``wordcount`` (string keys), and ``kmeans`` (the iterative pattern, a
``Result`` reused across runs).

Each submodule is imported at first use (``models.kmeans``), so a
process that needs one light module (a parse worker importing
``models.urls``) loads no other.
"""

import importlib

__all__ = ["kmeans", "maxint", "urls", "wordcount"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
