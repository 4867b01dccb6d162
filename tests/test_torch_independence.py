"""The port stands alone: nothing in ``src/repro_torch/`` or ``chip_smoke.py``
imports ``jax`` or the reference package ``repro`` (``repro_torch`` is the
port's own name and is allowed)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_has_files():
    assert len(FILES) > 10
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                     "from repro_torch.core import y\n")
    assert [n for n in _imported_modules(probe) if _forbidden(n)] == [
        "jax.numpy", "repro.core"]
