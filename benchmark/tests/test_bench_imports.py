"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every module's imports, read with
``ast``, compared by their whole top-level names."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "wav2letter_tpu"}
PROGRAM = "wav2letter_tpu_torch"


def modules():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def imports(path: Path):
    """(top-level name, relative level) of every import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".", 1)[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".", 1)[0], node.level))
    return out


def test_top_level_names_compare_whole():
    assert "wav2letter_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "wav2letter_tpu.ops".split(".", 1)[0] in FORBIDDEN


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    bad = [n for n, level in imports(path) if level == 0 and n in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [n for n, level in imports(path)
           if (level == 0 and n in FORBIDDEN | {PROGRAM, "benchmark"}) or level > 1]
    assert not bad, f"{path} imports {bad}"
