"""mmvae_tpu_torch stands alone: no file imports jax, flax, optax or the JAX
package, and every module imports in a process where those are blocked. Nor
does any file import scikit-learn, matplotlib or PIL, which the card's
machine lacks: the port has its own k-means, mixture EM and PNG writer. The
one exception is PIL inside `sources.load_celeba`, the reader of CelebA's
real PNG crops, which only real data reach: the stand-in loads where PIL is
blocked."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmvae_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmvae_tpu")
HOST_ONLY = ("sklearn", "matplotlib", "PIL")
# host-only packages a function may import inside its body: readers of real
# data files that the card's machine never holds
LAZY_HOST_ONLY = {("mmvae_tpu_torch/data/sources.py", "load_celeba"): ("PIL",)}


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path, skip=()):
    """The modules `path` imports, but for those imported inside the
    functions named in `skip`."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    skipped = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef) and f.name in skip
               for n in ast.walk(f)}
    for node in ast.walk(tree):
        if id(node) in skipped:
            continue
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
    lazy = {fn: mods for (f, fn), mods in LAZY_HOST_ONLY.items() if f == path}
    bad = [m for m in _imported(os.path.join(ROOT, path), skip=tuple(lazy))
           if m.split(".")[0] in HOST_ONLY]
    assert not bad, f"{path} imports {bad}"
    for fn, mods in lazy.items():  # the allowed function imports no other
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read())
        (body,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn]
        inside = {(a.name if isinstance(n, ast.Import) else n.module).split(".")[0]
                  for n in ast.walk(body) if isinstance(n, (ast.Import, ast.ImportFrom))
                  for a in n.names}
        assert inside & set(HOST_ONLY) <= set(mods), (fn, inside)


def test_celeba_stand_in_needs_no_pil():
    """The CelebA loader's synthetic stand-in, the card's only CelebA data,
    loads in a process where PIL is blocked."""
    code = "\n".join([
        "import sys",
        "sys.modules['PIL'] = None",
        "from mmvae_tpu_torch.data import get_dataloaders",
        "l = get_dataloaders('celeba', data_path='/nonexistent', synthetic_n=8, batch_size=4)",
        "print('ok', [x.num_examples for x in l])",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok [8, 2, 2]"


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
