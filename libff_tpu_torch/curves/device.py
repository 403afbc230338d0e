"""Field and group objects of one curve, built from its host CurveDef
(port of libff_tpu/curves/device.py: Fr, Fq, Fq2, G1 and G2).

Each group is built over the device field of the host field its curve is
over, as the reference maps them (``fmap``, libff_tpu/curves/device.py:
27-51): alt_bn128's and the BLS12s' G2 over Fq2, BW6-761's G2 over Fq
itself (its M-twist lies over the base field).  The port builds Fq and
the degree-2 tower; a curve with an Fq2 over another base raises, and so
does a group over a field the port does not build (Fq3 and the higher
towers wait for ROADMAP Queue 1 item 11).
"""

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
        fmap = {id(cd.fq): self.fq}
        self.fq2 = None
        if cd.fq2 is not None:
            if cd.fq2.B is not cd.fq:
                raise NotImplementedError(f"{cd.name} has no Fq2 over Fq")
            self.fq2 = ExtField(self.fq, cd.fq2, name=cd.fq2.name)
            fmap[id(cd.fq2)] = self.fq2

        def group(gdef):
            F = fmap.get(id(gdef.curve.F))
            if F is None:
                raise NotImplementedError(
                    f"{gdef.name} lies over {gdef.curve.F.name}: towers above "
                    "degree 2 wait for ROADMAP Queue 1 item 11")
            return Group(F, gdef)

        self.g1 = group(cd.g1)
        self.g2 = group(cd.g2)


@functools.lru_cache(maxsize=None)
def device_curve(name: str) -> DeviceCurve:
    return DeviceCurve(get_curve(name))
