"""The self-contained ``modeling_emmax.py`` of a Hub export, port of
``emmax_tpu/extern/standalone.py``.

:func:`build_standalone_source` bundles the module closure of the port's
Hub surface (the config, processor and facade modules and
``models.load``, with every module they import, at the top or inside a
function) into one file, so an exported directory loads with no
``emmax_torch`` installed. The JAX package splices every module into one
namespace; here each module keeps its own, because the port's modules
reuse names (``KERNEL``, ``_require_cuda``, ...) that one namespace would
clobber. The bundle holds each module's source under the private package
``_emmax_bundle`` (its imports renamed), and a finder on ``sys.meta_path``
executes a module when it is first imported.

Each bundled module's ``__file__`` is the path it would have in a package
rooted at the bundle's directory, so ``ops/cuda_build.py`` finds the
kernels' sources in ``<export dir>/csrc`` (``convert_weights.export_hf``
copies ``emmax_torch/csrc`` there) and builds them into ``<export
dir>/_build`` at first use, named by a hash of the sources, as in the
package. On the card the bundle runs the kernels, and raises where the
package raises (no ``nvcc``, say); it never gives way to the plain path.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List

PKG = "emmax_torch"
BUNDLE_PKG = "_emmax_bundle"
PKG_ROOT = Path(__file__).resolve().parent.parent

# Roots of the closure: the three auto_map surfaces and the loader.
ROOTS = [
    "emmax_torch.extern.hf_config",
    "emmax_torch.extern.hf_processor",
    "emmax_torch.extern.hf_facade",
    "emmax_torch.models.load",
]


def _mod_path(mod: str) -> Path:
    parts = mod.split(".")[1:]
    p = PKG_ROOT.joinpath(*parts[:-1], parts[-1] + ".py") if parts else None
    return p if p and p.exists() else PKG_ROOT.joinpath(*parts, "__init__.py")



def _imported(tree: ast.AST) -> List[str]:
    """The package's modules an AST imports, anywhere in it (a name
    imported from a package counts when it is a submodule)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == PKG or node.module.startswith(PKG + ".")):
            out.append(node.module)
            out += [f"{node.module}.{a.name}" for a in node.names
                    if _mod_path(f"{node.module}.{a.name}").exists()]
        elif isinstance(node, ast.Import):
            out += [a.name for a in node.names
                    if a.name == PKG or a.name.startswith(PKG + ".")]
    return out


def closure() -> List[str]:
    """Every module the roots reach, with each one's parent packages."""
    seen: Dict[str, None] = {}
    stack = list(ROOTS)
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen[mod] = None
        parts = mod.split(".")
        stack += [".".join(parts[:i]) for i in range(1, len(parts))]
        stack += _imported(ast.parse(_mod_path(mod).read_text()))
    return sorted(seen)


def _renamed(src: str) -> str:
    """The source with the package's imports pointed at the bundle's."""
    return re.sub(rf"(^|\s)(from|import)(\s+){PKG}\b",
                  rf"\1\2\3{BUNDLE_PKG}", src, flags=re.M)


_HEADER = '''\
"""modeling_emmax.py: a self-contained Emma-X model file (PyTorch; the
hand-written CUDA kernels built from ./csrc on the card at first use).

Generated by `emmax_torch.extern.standalone.build_standalone_source`; do
not edit by hand. It holds the sources of the emmax_torch modules that the
Hub surface reaches, as the private package `_emmax_bundle`, and imports
them from here: no emmax_torch install is needed. Dependencies: torch and
numpy (transformers only for the transformers-facing classes
EmmaXVLAConfig and EmmaXImageProcessor).

Entry points: EmmaXForVision2Seq.from_pretrained(dir), EmmaXProcessor,
load_vla(dir), EmmaXVLAConfig.
"""

import importlib
import importlib.abc
import importlib.util
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent
_BUNDLE = "{bundle}"
_PACKAGES = {packages!r}
_SOURCES = {{
'''

_FOOTER = '''\
}}


class _BundleImporter(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Serves the bundled modules; ``__file__`` as in a package rooted at
    this file's directory."""

    def find_spec(self, name, path=None, target=None):
        if name not in _SOURCES:
            return None
        return importlib.util.spec_from_loader(
            name, self, is_package=name in _PACKAGES)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        name = module.__name__
        rel = name.split(".")[1:]
        if name in _PACKAGES:
            module.__file__ = str(_ROOT.joinpath(*rel, "__init__.py"))
            module.__path__ = []
        else:
            module.__file__ = str(_ROOT.joinpath(*rel[:-1], rel[-1] + ".py"))
        exec(compile(_SOURCES[name], module.__file__, "exec"),
             module.__dict__)


if not any(type(f).__name__ == "_BundleImporter" for f in sys.meta_path):
    sys.meta_path.insert(0, _BundleImporter())

from {bundle}.extern.hf_facade import EmmaXForVision2Seq  # noqa: E402
from {bundle}.extern.hf_processor import (  # noqa: E402
    EmmaXImagePipeline, EmmaXProcessor)
from {bundle}.models.load import load, load_vla  # noqa: E402

_LAZY = {{"EmmaXVLAConfig": "{bundle}.extern.hf_config",
          "EmmaXConfig": "{bundle}.extern.hf_config",
          "EmmaXImageProcessor": "{bundle}.extern.hf_processor"}}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {{__name__!r}} has no attribute {{name!r}}")


__all__ = ["EmmaXForVision2Seq", "EmmaXProcessor", "EmmaXImagePipeline",
           "EmmaXVLAConfig", "EmmaXImageProcessor", "load_vla", "load"]
'''


def build_standalone_source() -> str:
    mods = closure()
    packages = sorted(m.replace(PKG, BUNDLE_PKG, 1) for m in mods
                      if _mod_path(m).name == "__init__.py")
    parts = [_HEADER.format(bundle=BUNDLE_PKG, packages=set(packages))]
    for mod in mods:
        name = mod.replace(PKG, BUNDLE_PKG, 1)
        parts.append(f"    {name!r}: {_renamed(_mod_path(mod).read_text())!r},"
                     "\n")
    parts.append(_FOOTER.format(bundle=BUNDLE_PKG))
    bundle = "".join(parts)
    ast.parse(bundle)   # the generated file must parse
    return bundle
