"""Model plugins — the port of ``wav2letter_tpu/models/plugin.py`` (the
reference's compiled ``createModule(nFeat, nLabel)`` plugin, loaded with
``--arch=arch.so``).

A plugin is a Python file or module exposing ``create_module(n_feat: int,
n_label: int) -> torch.nn.Module`` whose module maps ``(feats (B, T, C),
feat_len (B,), generator=None)`` to ``(emissions (B, T', N), out_len
(B,))``, in training or eval mode as ``.train()``/``.eval()`` set it;
``generator`` feeds its SpecAugment layers, as ``ArchModel``'s. Load with
``--arch=path/to/plugin.py`` or ``--arch=package.module:attr``.

A plugin of the JAX package is a flax module. Its file is read with ``ast``
before anything runs, so that no file importing ``jax``, ``flax``, ``optax``
or ``wav2letter_tpu`` is executed in the port's process. Such a file is
mapped to the port's counterpart by its path under ``recipes/`` (a JAX
checkpoint stores ``--arch`` as it was given, and ``cli.test`` and
``continue`` rebuild the model from it); any other raises.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import os
from typing import List

from torch import nn

JAX_MODULES = ("jax", "flax", "optax", "wav2letter_tpu")
# the JAX package's plugins under recipes/ -> their counterparts in the port
PORTED = {"recipes/mls/mling_plugin.py": "wav2letter_tpu_torch.plugins.mling"}


def is_plugin(arch: str) -> bool:
    return arch.endswith(".py") or ":" in arch


def load_plugin_module(spec: str, n_feat: int, n_label: int) -> nn.Module:
    if spec.endswith(".py"):
        path, modname, attr = spec, "", ""
    else:
        modname, _, attr = spec.partition(":")
        path = _module_file(modname)
    mod = _load(path, spec, modname)
    if attr:
        mod = getattr(mod, attr)
    fn = getattr(mod, "create_module", None)
    if fn is None:
        raise ValueError(f"plugin {spec!r} does not define create_module(n_feat, n_label)")
    return fn(n_feat, n_label)


def _ported(path: str):
    norm = os.path.normpath(path).replace(os.sep, "/")
    for key, target in PORTED.items():
        if norm == key or norm.endswith("/" + key):
            return target
    return None


def _load(path: str, spec: str, modname: str):
    target = _ported(path)
    if target is not None:
        return importlib.import_module(target)
    bad = jax_imports(path)
    if bad:
        raise ValueError(
            f"plugin {spec!r} imports {', '.join(bad)}: it is a plugin of the JAX "
            "package, and the PyTorch port has no counterpart of it; a plugin of the "
            "port must be written in torch")
    if modname:
        return importlib.import_module(modname)
    name = os.path.splitext(os.path.basename(path))[0]
    mspec = importlib.util.spec_from_file_location(f"w2l_plugin_{name}", path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod


def jax_imports(path: str) -> List[str]:
    """The JAX-side modules that the file at ``path`` imports, read without
    running it."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in JAX_MODULES]
    return sorted(set(found))


def _module_file(modname: str) -> str:
    """The source file of ``modname`` (finding it imports its parent
    packages, not the module)."""
    if modname.split(".")[0] in JAX_MODULES:
        raise ValueError(f"plugin module {modname!r} is of the JAX package; a plugin "
                         "of the port must be written in torch")
    path = modname.replace(".", "/") + ".py"
    if _ported(path):
        return path
    spec = importlib.util.find_spec(modname)
    if spec is None or not spec.origin:
        raise ModuleNotFoundError(f"no module named {modname!r}")
    return spec.origin
