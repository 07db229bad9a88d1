"""Nothing the benchmark runs imports JAX, Flax or the JAX package, by
whole top-level module name (``repro_torch`` is not ``repro``), and the
reference imports nothing of the port."""
import ast
import subprocess
import sys

import pytest

from conftest import REPO

BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((REPO / "fl_bench").rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_banned_import(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & BANNED
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_a_run_loads_no_banned_module(bench_root):
    """A CPU run in a fresh interpreter, then the check ``run.py`` makes
    once its window has closed."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import run_cell\n"
        "from pathlib import Path\n"
        "out = run_cell(Path(%r), 'tiny.fedbuff')\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('run', %r); m = u.module_from_spec(s)\n"
        "s.loader.exec_module(m)\n"
        "print(m.banned_modules(), out['correct'])\n"
    ) % (str(REPO / "fl_bench" / "tests"), str(REPO / "src"), str(REPO),
         str(bench_root), str(REPO / "fl_bench" / "run.py"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and ``fl_bench/``."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "fl_bench", tmp_path / "fl_bench")
    res = subprocess.run(
        [sys.executable, "fl_bench/run.py", "--workload", "mnv3.sync.geo7",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
