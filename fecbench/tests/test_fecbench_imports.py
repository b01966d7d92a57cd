"""Nothing under fecbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and nothing under fecbench/reference/ imports the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

FECBENCH = Path(__file__).resolve().parent.parent
ROOT = FECBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "libpoporon_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(FECBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(FECBENCH)))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((FECBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert all(not n.startswith("libpoporon") for n in imported(path))


def test_loaded_modules():
    """What the harness loads, the program with it, holds no JAX module."""
    code = ("import sys, json, importlib, pathlib\n"
            "import libpoporon_tpu_torch, libpoporon_tpu_torch.parallel\n"
            "from fecbench import generator, run\n"
            "for p in sorted(pathlib.Path('fecbench').rglob('*.py')):\n"
            "    if p.parent.name in ('metrics', 'entries', 'channels'):\n"
            "        generator.load(p.parent.name, p.stem)\n"
            "    elif 'tests' not in p.parts:\n"
            "        importlib.import_module('.'.join(p.with_suffix('').parts))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert not set(json.loads(out)) & FORBIDDEN
