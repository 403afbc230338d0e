"""Field and group objects of one curve, built from its host CurveDef
(port of libff_tpu/curves/device.py, G1 only in this slice)."""

from __future__ import annotations

import functools

from libff_tpu.curves.curvedef import CurveDef, get_curve
from libff_tpu.host.ec import EdwardsCurve

from ..fields.fp import PrimeField
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

    @property
    def g2(self):
        raise NotImplementedError("G2 is a later slice")


@functools.lru_cache(maxsize=None)
def device_curve(name: str) -> DeviceCurve:
    return DeviceCurve(get_curve(name))
