"""The port stands apart from JAX.

An AST scan of every module of ``libff_tpu_torch`` and of ``chip_smoke.py``
finds no ``jax`` import and no import of the JAX package outside its
jax-free host modules; importing the whole port in a fresh interpreter
leaves ``jax`` out of ``sys.modules`` and needs no ``nvcc`` and no card,
and a group op leaves out ``sympy`` too (its import cost seconds in the
first MSM).  ``chip_smoke.py`` refuses to run without a card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "libff_tpu_torch"
FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")
               if "_build" not in p.parts) + ["chip_smoke.py"]

# the modules of the JAX package that import no jax, which the port may use
ALLOWED = ("libff_tpu.host.mont", "libff_tpu.host.field", "libff_tpu.host.ec",
           "libff_tpu.curves.curvedef", "libff_tpu.curves.formulas")


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


def _allowed(name: str) -> bool:
    if name in ("libff_tpu", "libff_tpu.host", "libff_tpu.curves"):
        return False
    return any(name == a or name.startswith(a + ".") for a in ALLOWED)


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    names = _imports(ROOT / rel)
    assert not [n for n in names if n == "jax" or n.startswith("jax.")]
    ref = [n for n in names if n == "libff_tpu" or n.startswith("libff_tpu.")]
    # "from libff_tpu.host import mont" names both the package and the module
    bad = [n for n in ref if not _allowed(n)
           and not any(m.startswith(n + ".") and _allowed(m) for m in ref)]
    assert not bad, f"{rel} imports {bad}"


def _run(code: str, cwd: Path, **env) -> subprocess.CompletedProcess:
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out():
    mods = [f[:-3].replace("/", ".").removesuffix(".__init__")
            for f in FILES if f.startswith("libff_tpu_torch/")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from libff_tpu_torch.curves.device import device_curve\n"
            "from libff_tpu_torch.curves.group import ProjectivePoint\n"
            "G = device_curve('alt_bn128').g1\n"
            "P = ProjectivePoint(*(G.F.one((2, 1)) for _ in range(3)))\n"
            "G.padd(P, ProjectivePoint(*(G.F.one((2,)) for _ in range(3))))\n"
            "assert 'sympy' not in sys.modules, 'a group op imported sympy'\n"
            "from libff_tpu_torch import _build\n"
            "assert not _build._libs, 'importing loaded a kernel library'\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'jax'],"
            " sorted(m for m in sys.modules if m.startswith('jax'))\n"
            "print('ok')\n")
    r = _run(code, ROOT, PATH="/usr/bin:/bin")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card():
    """With no CUDA card the script exits non-zero and prints no result."""
    r = _run("import runpy, sys; sys.argv = ['chip_smoke.py'];"
             " runpy.run_path('chip_smoke.py', run_name='__main__')",
             ROOT, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and r.stdout.strip() == ""
