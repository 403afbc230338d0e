"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and ``nvcc``; without them it skips.
The kernels have no CPU mode, so these tests are the kernels' own
pytest-level check (``chip_smoke.py`` checks them at the main path's
shapes).  On a machine with a card, from the repository root:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: that machine has no jax, which tests/conftest.py
imports.)  Comparisons are exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from libff_tpu_torch import _build, convert, workload
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group_ops import OPS, group_op, group_op_plain
from libff_tpu_torch.fields.fp import fp_op, fp_op_plain
from libff_tpu_torch.msm.insert import insert, insert_plain
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _build.build()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def dc():
    return device_curve("alt_bn128")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_k1e_matches_plain(dev, dc, op):
    F = dc.fq
    rng = np.random.default_rng(1)
    a = chip_smoke.rand_elements(F, 4099, rng, dev)
    b = chip_smoke.rand_elements(F, 4099, rng, dev)
    edges = [0, 1, F.p - 1, F.p - 2, F.mp.R % F.p]
    a[:, :5], b[:, 5:10] = F.plain_from_ints(edges, dev), \
        F.plain_from_ints(edges, dev)
    before = _build.LAUNCHES["K1e"]
    got = fp_op(F, op, a, b)
    assert _build.LAUNCHES["K1e"] == before + 1
    assert torch.equal(got, fp_op_plain(F, op, a, b))


@pytest.mark.parametrize("op", sorted(OPS))
def test_k3_matches_plain(dev, dc, op):
    G = dc.g1
    rng = np.random.default_rng(2)
    c, cm, q_inf = chip_smoke.k3_inputs(G.F, 3000, rng, dev)
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    before = _build.LAUNCHES["K3"]
    got = group_op(G, op, coords, masks)
    assert _build.LAUNCHES["K3"] == before + 1
    for g, w in zip(got, group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)


def test_k2_matches_plain(dev, dc):
    # distinct points, some at infinity: the MSM workload's points repeat
    # with period 32, which a kernel reading the wrong point would not show
    d, pts, B = chip_smoke.k2_inputs(dc, 1 << 12, MsmConfig(c=8, lanes=256),
                                     np.random.default_rng(3), dev)
    assert bool(pts[3].any())
    before = _build.LAUNCHES["K2"]
    got = insert(dc.g1, d, pts, B)
    assert _build.LAUNCHES["K2"] == before + 1
    for g, w in zip(got, insert_plain(dc.g1, d, pts, B)):
        assert torch.equal(g, w)


def test_msm_matches_oracle_and_keeps_current_device(dev, dc):
    n = 1 << 12
    limbs, x, y = workload.msm_inputs(dc.cd, n, 4)
    s = convert.field_to_torch(limbs, dev)
    A = convert.affine_to_torch((x, y, np.zeros(n, dtype=bool)), dev)
    current = torch.cuda.current_device()
    aff = dc.g1.to_affine(msm_pippenger(dc.g1, s, A, 254))
    assert torch.cuda.current_device() == current
    got = (dc.fq.to_ints(aff.x)[0], dc.fq.to_ints(aff.y)[0])
    assert got == workload.oracle(dc.cd, workload.class_sums(limbs))
