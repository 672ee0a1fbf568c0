"""Nothing the benchmark runs, and no module of the port, imports JAX or the
JAX package; the names are compared whole (``videomamba_tpu_torch`` is not
``videomamba_tpu``). The reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

from benchmark import harness

BLOCKED = set(harness.BLOCKED)


def python_files(top):
    for base, _, files in os.walk(os.path.join(ROOT, top)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def imported(path, module_level_only):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    nodes = tree.body if module_level_only else ast.walk(tree)
    out = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_whole_name_is_compared():
    assert "videomamba_tpu_torch".split(".")[0] not in BLOCKED
    assert {"jax", "jaxlib", "flax", "videomamba_tpu"} <= BLOCKED


@pytest.mark.parametrize("top", ["benchmark", "videomamba_tpu_torch"])
def test_no_module_imports_jax_or_the_jax_package(top):
    bad = {}
    for path in python_files(top):
        names = imported(path, module_level_only=(top == "videomamba_tpu_torch")) & BLOCKED
        if names:
            bad[os.path.relpath(path, ROOT)] = sorted(names)
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    for path in python_files(os.path.join("benchmark", "reference")):
        assert not imported(path, False) & (BLOCKED | {"videomamba_tpu_torch", "benchmark"}), path


def test_blocked_modules_compares_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "videomamba_tpu_torch_fake", object())
    assert "videomamba_tpu_torch_fake" not in harness.blocked_modules()
    monkeypatch.setitem(sys.modules, "videomamba_tpu.fake", object())
    assert "videomamba_tpu" in harness.blocked_modules()


def test_every_benchmark_module_loads_with_jax_blocked():
    """In a process where importing jax, flax or the JAX package fails, the
    harness, the control, every driver, reference and metric reader, and
    the port's modules they import load, and no blocked name is loaded."""
    code = f"""
import importlib, importlib.abc, sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'videomamba_tpu')
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(name + ' is blocked')
sys.meta_path.insert(0, Block())
sys.path.insert(0, {ROOT!r})
from benchmark import harness, program
import benchmark.control
bench = harness.Bench({ROOT!r})
for w in bench.spec['workloads']:
    cfg, mix = bench.config(w['config']), bench.traffic(w['traffic'])
    bench.driver(mix['driver']); bench.reference(cfg['reference'])
for m in bench.spec['end_to_end'] + bench.spec['per_layer']:
    bench.reader(m['name'])
import videomamba_tpu_torch.runtime, videomamba_tpu_torch.parallel.train_step
program.launch_counts()
assert not harness.blocked_modules(), harness.blocked_modules()
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
