"""The port's own copies of the JAX package's jax-free modules stay what
they copy.

The port imports nothing of ``libff_tpu``; it carries copies of
``host/{mont,field,ec}.py`` and ``curves/{curvedef,formulas,alt_bn128,
bls12_381,bls12_377}.py``.  These tests hold the copies to the
originals: the host modules and the formulas function by function (same
source body), each curve module whole (its imports are the same
relative ones), and alt_bn128's curve data value by value (moduli,
generators, b, the twist's b', the non-residues and Frobenius tables of
Fq2, Fq6 and Fq12).  ``curvedef`` differs on purpose: it registers the
copied curves only, and ``get_curve`` of another curve raises until its
module is copied too.
"""

import inspect

import pytest

import importlib

import libff_tpu.curves.alt_bn128  # noqa: F401  (registers the curve)
from libff_tpu.curves import curvedef as jcurvedef
from libff_tpu.curves import formulas as jformulas
from libff_tpu.host import ec as jec
from libff_tpu.host import field as jfield
from libff_tpu.host import mont as jmont
from libff_tpu_torch.curves import curvedef, formulas
from libff_tpu_torch.host import ec, field, mont

PAIRS = [(mont, jmont), (field, jfield), (ec, jec), (formulas, jformulas)]


def _members(mod):
    """Functions and classes defined in mod (not imported into it)."""
    return {name: obj for name, obj in vars(mod).items()
            if (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == mod.__name__}


@pytest.mark.parametrize("port,ref", PAIRS, ids=[p[1].__name__ for p in PAIRS])
def test_copy_has_the_same_source(port, ref):
    ours, theirs = _members(port), _members(ref)
    assert set(ours) == set(theirs)
    for name, obj in theirs.items():
        assert inspect.getsource(ours[name]) == inspect.getsource(obj), name


def _curve_data(cd):
    fq2, fq6, fq12 = cd.fq2, cd.fq6, cd.fq12
    return {
        "q": cd.q, "r": cd.r, "fq_bits": cd.fq.mp.bits,
        "g1": (cd.g1.generator, cd.g1.curve.a, cd.g1.curve.b, cd.g1.order,
               cd.g1.cofactor),
        "g2": (cd.g2.generator, cd.g2.curve.a, cd.g2.curve.b, cd.g2.order,
               cd.g2.cofactor),
        "nr": (fq2.nr, fq6.nr, fq12.nr),
        "frobenius": (fq2.frobenius_coeffs(), fq6.frobenius_coeffs(),
                      fq12.frobenius_coeffs()),
    }


def test_alt_bn128_constants_equal_the_reference():
    assert _curve_data(curvedef.get_curve("alt_bn128")) == \
        _curve_data(jcurvedef.get_curve("alt_bn128"))


@pytest.mark.parametrize("name", ["alt_bn128", "bls12_381", "bls12_377"])
def test_curve_modules_are_whole_copies(name):
    port = importlib.import_module(f"libff_tpu_torch.curves.{name}")
    ref = importlib.import_module(f"libff_tpu.curves.{name}")
    assert inspect.getsource(port) == inspect.getsource(ref)


def test_other_curves_wait_for_their_copies():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        curvedef.get_curve("bw6_761")
    with pytest.raises(KeyError):
        curvedef.get_curve("no_such_curve")
