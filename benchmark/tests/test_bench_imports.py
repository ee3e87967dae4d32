"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name is
compared whole (the port's name begins with the JAX package's)."""

import ast
import os

from benchmark import cells

JAX = {"jax", "jaxlib", "flax", "mmvae_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources(cells.BENCH_DIR) for m in _imports(p) if m in JAX}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(cells.BENCH_DIR, "reference")
    found = {(p, m) for p in _sources(ref) for m in _imports(p)
             if m in JAX | {"mmvae_tpu_torch", "benchmark"}}
    assert not found


def test_the_comparison_is_by_whole_names():
    assert "mmvae_tpu_torch" not in JAX and "mmvae_tpu_torch".startswith("mmvae_tpu")
