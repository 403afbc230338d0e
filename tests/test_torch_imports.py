"""The port stands apart from JAX.

An AST scan of every module of ``libff_tpu_torch`` (its own copies of the
JAX package's jax-free modules included) and of ``chip_smoke.py`` finds no
``jax`` import and no import of the JAX package ``libff_tpu`` at all.
Importing the whole port in a fresh interpreter and running one G1 and one
G2 group op and one lane merge leaves ``jax`` and every ``libff_tpu``
module out of ``sys.modules``, needs no ``nvcc`` and no card, and leaves out ``sympy``
too (its import cost seconds in the first MSM).  ``chip_smoke.py`` refuses
to run without a card.
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

# the modules of the JAX package the port may import: none, it keeps its
# own copies
ALLOWED = ()


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


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    names = _imports(ROOT / rel)
    assert not [n for n in names if n == "jax" or n.startswith("jax.")]
    bad = [n for n in names if (n == "libff_tpu" or n.startswith("libff_tpu."))
           and not any(n == a or n.startswith(a + ".") for a in ALLOWED)]
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
            "from libff_tpu_torch.msm.merge import merge_lanes\n"
            "dc = device_curve('alt_bn128')\n"
            "for G in (dc.g1, dc.g2):\n"
            "    P = ProjectivePoint(*(G.F.one((2, 1), 'cpu')\n"
            "                          for _ in range(3)))\n"
            "    G.padd(P, ProjectivePoint(*(G.F.one((2,), 'cpu')\n"
            "                                for _ in range(3))))\n"
            "    merge_lanes(G, ProjectivePoint(*(G.F.one((1, 1, 4), 'cpu')\n"
            "                                     for _ in range(3))))\n"
            "assert 'sympy' not in sys.modules, 'a group op imported sympy'\n"
            "from libff_tpu_torch import _build\n"
            "assert not _build._libs, 'importing loaded a kernel library'\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'jax'],"
            " sorted(m for m in sys.modules if m.startswith('jax'))\n"
            "assert not [m for m in sys.modules"
            " if m.split('.')[0] == 'libff_tpu'],"
            " sorted(m for m in sys.modules if m.startswith('libff_tpu.'))\n"
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
