"""Field and group objects of one curve, built from its host CurveDef
(port of libff_tpu/curves/device.py: Fr, Fq, Fq2, G1 and G2)."""

from __future__ import annotations

import functools

from ..fields.fp import PrimeField
from ..fields.tower import ExtField
from ..host.ec import EdwardsCurve
from .curvedef import CurveDef, get_curve
from .group import Group


class DeviceCurve:
    def __init__(self, cd: CurveDef):
        self.cd = cd
        self.name = cd.name
        self.r = cd.r
        self.q = cd.q
        self.fr = PrimeField(cd.r, cd.fr.mp.bits, cd.fr.name)
        self.fq = PrimeField(cd.q, cd.fq.mp.bits, cd.fq.name)
        if isinstance(cd.g1.curve, EdwardsCurve):
            raise NotImplementedError(
                "Edwards groups wait for ROADMAP Queue 1 item 10")
        if cd.g1.curve.F is not cd.fq:
            raise NotImplementedError("G1 over an extension field")
        self.g1 = Group(self.fq, cd.g1)
        # the degree-2 tower; Fq3 and the higher towers wait for ROADMAP
        # Queue 1 item 11
        if cd.fq2 is None or cd.fq2.B is not cd.fq:
            raise NotImplementedError(f"{cd.name} has no Fq2 over Fq")
        self.fq2 = ExtField(self.fq, cd.fq2, name=cd.fq2.name)
        if cd.g2.curve.F is not cd.fq2:
            raise NotImplementedError(f"{cd.name} G2 is not over Fq2")
        self.g2 = Group(self.fq2, cd.g2)


@functools.lru_cache(maxsize=None)
def device_curve(name: str) -> DeviceCurve:
    return DeviceCurve(get_curve(name))
