"""Import hygiene of the port: no module of src/repro_torch and no line of
chip_smoke.py imports JAX or the reference package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in \
                ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(ln, name) for ln, name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_banned_imports(tmp_path):
    f = tmp_path / "m.py"
    for src in ("import jax\n", "from jax import numpy\n",
                "import repro.core.apps\n", "from repro import core\n",
                "from repro.core import apps\n",
                "import importlib\nimportlib.import_module('repro.x')\n"):
        f.write_text(src)
        assert any(_banned(n) for _, n in _imports(f)), src
    f.write_text("import repro_torch.core\nfrom repro_torch import bridge\n")
    assert not any(_banned(n) for _, n in _imports(f))
