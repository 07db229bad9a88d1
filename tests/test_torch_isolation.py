"""The port stands alone: nothing in ``src/repro_torch/`` (``_dist.py``,
the process group, among them), ``examples_torch/``, ``chip_smoke.py`` or
the spawned ranks' entry point ``tests/torch_multidevice_worker.py``
imports JAX or the JAX package ``repro``.

Two checks: an AST walk of every source file for ``import jax`` /
``jaxlib`` / ``repro`` (absolute imports of ``repro_torch`` are fine),
and an import of every port module in a fresh interpreter in which
``jax``, ``jaxlib`` and ``repro`` cannot be imported at all. Beside
them, the paper tiers' models dispatch as every entry point does: with
no device named they run on the card, and raise where there is none.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.paper_tiers import TIER_ORDER, build_tier_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
TWINS = sorted((ROOT / "examples_torch").glob("*.py"))
# the entry point of tests/test_torch_multidevice.py's spawned ranks
WORKER = ROOT / "tests" / "torch_multidevice_worker.py"
SOURCES = sorted(PORT.rglob("*.py")) + TWINS + [ROOT / "chip_smoke.py",
                                                 WORKER]


def forbidden_imports(path: Path):
    """-> [(line, module)] of the file's imports of a forbidden package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue  # relative imports stay inside the port
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_repro(path):
    assert forbidden_imports(path) == []


def test_lint_catches_forbidden_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                   "from repro_torch import _tree\nfrom . import y\n"
                   "def f():\n    import jaxlib\n")
    assert [m for _, m in forbidden_imports(bad)] == \
        ["jax.numpy", "repro.core", "jaxlib"]


def test_port_imports_with_jax_blocked():
    """Every port module, the example twins and chip_smoke.py import in an
    interpreter where ``import jax`` / ``import repro`` raise ImportError."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "import importlib.util\n"
            f"for path in {[str(p) for p in TWINS + [WORKER]]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('twin', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert 'repro_torch.launch.fl_train' in sys.modules\n"
            "assert 'repro_torch._dist' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("tier", TIER_ORDER)
def test_tier_model_defaults_to_cuda(tier):
    if torch.cuda.is_available():
        model, _ = build_tier_model(tier)
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_tier_model(tier)
