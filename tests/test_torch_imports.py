"""mmvae_tpu_torch stands alone: no file imports jax, flax, optax or the JAX
package, and every module imports in a process where those are blocked. Nor
does any file import scikit-learn, matplotlib or PIL, which the card's
machine lacks: the port has its own k-means, mixture EM and PNG writer."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmvae_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmvae_tpu")
HOST_ONLY = ("sklearn", "matplotlib", "PIL")


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _py_files()))
def test_no_jax_imports(path):
    bad = [m for m in _imported(os.path.join(ROOT, path)) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _py_files()))
def test_no_host_only_imports(path):
    bad = [m for m in _imported(os.path.join(ROOT, path)) if m.split(".")[0] in HOST_ONLY]
    assert not bad, f"{path} imports {bad}"


def _module_name(path):
    parts = os.path.relpath(path, ROOT)[:-3].split(os.sep)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_package_imports_without_jax():
    modules = sorted(_module_name(p) for p in _py_files())
    code = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{name!r}] = None" for name in FORBIDDEN],
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
