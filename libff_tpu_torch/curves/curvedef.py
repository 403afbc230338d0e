"""Curve definition objects (host side).

libff instantiates each curve by mutating static members from decimal-string
literals inside init_<curve>_params() (e.g. alt_bn128_init.cpp:32-458).
Here a curve is a plain immutable *value*: a ``CurveDef`` built from a small
set of seed constants (moduli, non-residues, generators, cofactors, loop
counts — public curve data), with every derived constant (Montgomery
parameters, Frobenius coefficient tables, twist coefficients, final
exponents) computed at import time by the host field layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..host import field as hf


@dataclasses.dataclass(frozen=True)
class GroupDef:
    name: str
    curve: hf.Fp.__class__ | Any      # host WeierstrassCurve
    generator: tuple                   # affine (x, y) host field elements
    cofactor: int
    order: int                         # prime subgroup order r
    wnaf_window_table: tuple
    fixed_base_exp_window_table: tuple
    # curve-specific extras: endomorphism constants, fast subgroup-check
    # parameters (e.g. bls12_377's sigma/psi data)
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PairingDef:
    """Parameters of the (optimal) ate pairing.

    kind: 'bn' (alt_bn128) | 'bls12' | 'bw6' | 'mnt4' | 'mnt6' | 'edwards'
    """
    kind: str
    ate_loop_count: int
    ate_is_loop_count_neg: bool
    final_exponent: int                # (q^k - 1) / r
    final_exponent_z: int              # curve parameter |u|
    final_exponent_is_z_neg: bool
    twist: Any                         # xi in Fq2 (or None)
    twist_type: str                    # 'D' or 'M'
    embedding_degree: int
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CurveDef:
    name: str
    r: int
    q: int
    fr: hf.Fp
    fq: hf.Fp
    # seed data that libff stores per field (used by sqrt / FFT domains)
    fr_nqr: int
    fr_multiplicative_generator: int
    fq_nqr: int
    fq_multiplicative_generator: int
    # tower (entries may be None for curves without that level)
    fq2: Optional[hf.Ext]
    fq3: Optional[hf.Ext]
    fq6: Optional[hf.Ext]
    fq12: Optional[hf.Ext]
    gt: Any                            # the GT field (e.g. fq12)
    g1: GroupDef
    g2: GroupDef
    pairing: Optional[PairingDef]
    fq4: Optional[hf.Ext] = None       # MNT4's GT level (2-over-2)

    @property
    def coeff_b(self):
        return self.g1.curve.b

    @property
    def coeff_a(self):
        return self.g1.curve.a


_REGISTRY: dict[str, CurveDef] = {}


def register(cd: CurveDef) -> CurveDef:
    _REGISTRY[cd.name] = cd
    return cd


# the reference's other curve modules, which the port has not copied yet,
# and the ROADMAP Queue 1 items each waits for
_LATER = {
    "mnt4": "item 10 (a != 0, 10-limb fields) and item 11 (Fq4 towers)",
    "mnt6": "item 10 (a != 0, 10-limb fields) and item 11 (Fq3 towers)",
    "edwards": "item 10 (Edwards groups)",
}


def get_curve(name: str) -> CurveDef:
    if name not in _REGISTRY:
        _import_curve_modules()
    if name in _LATER:
        raise NotImplementedError(
            f"curve {name} waits for ROADMAP Queue 1 {_LATER[name]}")
    return _REGISTRY[name]


def _import_curve_modules() -> None:
    """Lazy-import every available curve module (each registers itself).
    The port carries alt_bn128, bls12_381, bls12_377 and bw6_761; the
    rest come with the items of _LATER."""
    import importlib

    for mod in ("alt_bn128", "bls12_381", "bls12_377", "bw6_761"):
        try:
            importlib.import_module(f".{mod}", __package__)
        except ImportError:
            pass


def available_curves() -> list[str]:
    _import_curve_modules()
    return sorted(_REGISTRY)
