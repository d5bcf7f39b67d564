"""Small helpers: module registry, name-based class lookup, filename resolution.

Mirrors the extension mechanism of the reference (kge/misc.py:13-42): components
are located by scanning a list of registered python modules for a class with a
given name, and yaml option files are located by scanning the same modules'
directories.

Configurations written by the JAX package name its modules (``kge_tpu.job``,
``kge_tpu.models``, ...). Every lookup here reads such a name as the
corresponding module of this package, so a folder or checkpoint written by
the JAX package never imports it.
"""

from __future__ import annotations

import importlib
import os
from typing import List

_JAX_PACKAGE = "kge_tpu"
_PACKAGE = "kge_tpu_torch"


def port_module_name(module_name: str) -> str:
    """``kge_tpu[.x]`` -> ``kge_tpu_torch[.x]``; other names unchanged."""
    if module_name == _JAX_PACKAGE or module_name.startswith(_JAX_PACKAGE + "."):
        return _PACKAGE + module_name[len(_JAX_PACKAGE):]
    return module_name


def jax_module_name(module_name: str) -> str:
    """``kge_tpu_torch[.x]`` -> ``kge_tpu[.x]``; other names unchanged. Files
    that both packages read (``config.yaml``, checkpoints) name the JAX
    package's modules."""
    if module_name == _PACKAGE or module_name.startswith(_PACKAGE + "."):
        return _JAX_PACKAGE + module_name[len(_PACKAGE):]
    return module_name


def module_base_dir(module_name: str) -> str:
    module = importlib.import_module(port_module_name(module_name))
    return os.path.dirname(os.path.abspath(module.__file__))


def kge_base_dir() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def filename_in_module(module_names, filename: str) -> str:
    """Return the path of ``filename`` in the first module that contains it."""
    if isinstance(module_names, str):
        module_names = [module_names]
    for module_name in module_names:
        f = os.path.join(module_base_dir(module_name), filename)
        if os.path.exists(f):
            return f
    raise FileNotFoundError(
        "{} not found in one of modules {}".format(filename, module_names)
    )


def init_from(class_name: str, module_names: List[str], *args, **kwargs):
    """Instantiate class ``class_name`` scanning ``module_names`` for it."""
    looked_in = []
    for module_name in module_names:
        module_name = port_module_name(module_name)
        module = importlib.import_module(module_name)
        looked_in.append(module_name)
        if hasattr(module, class_name):
            return getattr(module, class_name)(*args, **kwargs)
    raise ValueError(
        "class {} not found in modules {}".format(class_name, looked_in)
    )


def round_to_points(round_points_to: List[int], to_be_rounded: int) -> int:
    """Round ``to_be_rounded`` to the nearest of the given points."""
    if len(round_points_to) > 0:
        return min(round_points_to, key=lambda x: abs(x - to_be_rounded))
    return to_be_rounded


def is_number(s, number_type) -> bool:
    try:
        number_type(s)
        return True
    except ValueError:
        return False
