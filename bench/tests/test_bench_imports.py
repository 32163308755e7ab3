"""No run loads JAX or the JAX package, and nothing in the harness reads
the JAX package's benchmarks; the reference imports nothing of the
program."""
import ast
import subprocess
import sys

from bench_tiny import BENCH

SCRIPT = r"""
import sys
sys.path[:0] = [{bench!r}, {src!r}]
import torch
import run
from benchkit.drivers import serve, train
sys.path.insert(0, {tests!r})
from bench_tiny import config, serve_mix, train_mix
cpu = torch.device("cpu")
lim = {{"grad_gap": 1, "change_gap": 1, "served_logit_gap": 1}}
train.run(config(), train_mix(), lim, 5, 0.2, False, cpu, 0.0)
serve.run(config("internlm2-1.8b"), serve_mix(), lim, 5, 0.2, False, cpu, 0.0)
print("FOUND", run.forbidden_modules())
"""


def test_no_forbidden_module_after_a_run():
    code = SCRIPT.format(bench=str(BENCH), src=str(BENCH.parent / "src"),
                         tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_the_reference_no_program():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                           "examples"}, path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops and "benchkit" not in tops, path
        if path.name != "test_bench_imports.py":
            assert "benchmarks/" not in path.read_text(), path
