"""The port stands alone: no file under sheeprl_tpu_torch/ imports jax (or
its libraries), the reference package, gymnasium or cv2; and importing the
port and its serving path in a fresh interpreter loads neither jax nor
sheeprl_tpu (a subprocess, because tests/conftest.py imports jax here)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

PORT = pathlib.Path(__file__).resolve().parent.parent / "sheeprl_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sheeprl_tpu", "gymnasium", "cv2"}
PY_FILES = sorted(PORT.rglob("*.py"))


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_python_files():
    assert len(PY_FILES) > 20


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(PORT)))
def test_no_forbidden_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_import_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import sheeprl_tpu_torch.cli, sheeprl_tpu_torch.algos\n"
        "import sheeprl_tpu_torch.serve.serve, sheeprl_tpu_torch.serve.policies\n"
        "import sheeprl_tpu_torch.serve.client, sheeprl_tpu_torch.interop\n"
        "import sheeprl_tpu_torch.algos.dreamer_v3.agent\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sheeprl_tpu', 'gymnasium', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT.parent, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
