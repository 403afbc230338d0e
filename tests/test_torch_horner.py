"""K3's scan entry (the MSM's Horner phase) and K3's G2 pair schedule on
the CPU.

``horner_scan`` on CPU tensors runs ``horner_scan_plain``: c*(W-1) masked
doubling steps and the sum tree padded with the identity.  It must give
the bits of the per-step loop that ``_horner_complete`` ran before it
(``Group.pdbl``, ``Group.select`` and ``Group.proj_sum_tree``), on the toy
curve of tests/test_pallas_interpret.py (p = 65539, b = 11) at W in {5,
8} and c in {2, 3}, some totals at the identity; W = 5 pads the tree.
It must also equal a golden written once from the JAX package's
``_horner_complete(direct="scan")`` (libff_tpu/msm/pippenger.py:419-433)
for alt_bn128 G1 and G2 at W = 4, c = 2
(tests/data/horner_scan_golden.json; ``PYTHONPATH=. python
tests/test_torch_horner.py`` from the repository root writes it again).
The pair schedule of K3's G2 branch (``group_op_pair_plain``: each Fq2
product as two lanes' lazy sums, one reduction each) must give
``group_op_plain``'s bits on alt_bn128 G2 with the edge lanes of
``workload.k3_inputs``.  All comparisons are exact.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from libff_tpu_torch.curves.curvedef import GroupDef
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import Group, ProjectivePoint
from libff_tpu_torch.curves.group_ops import (OPS, group_op_pair_plain,
                                              group_op_plain, horner_scan,
                                              horner_scan_plain)
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.host import ec as hec
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.workload import k3_inputs
from tests.test_pallas_interpret import B_TOY, GEN_TOY, N_TOY, P_TOY

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "data" / "horner_scan_golden.json"


@pytest.fixture(scope="module")
def toy():
    Fh = hf.Fp(P_TOY, name="toy_Fp")
    E = hec.WeierstrassCurve(Fh, 0, B_TOY, name="toy_E")
    gdef = GroupDef(name="toy", curve=E, generator=GEN_TOY, cofactor=1,
                    order=N_TOY, wnaf_window_table=(4,),
                    fixed_base_exp_window_table=(1,))
    return E, Group(PrimeField(P_TOY, name="toy_Fp"), gdef)


def _loop(G, totals: ProjectivePoint, c: int) -> ProjectivePoint:
    """The per-step Horner of _horner_complete before the scan entry."""
    W = totals.z.shape[-1]
    thresh = c * torch.arange(W, device=totals.z.device)
    P = totals
    for k in range(c * (W - 1)):
        P = G.select(k < thresh, G.pdbl(P), P)
    return G.proj_sum_tree(P, axis=-1)


def _proj_cols(H, pts, zs):
    """Host affine points (None: the identity) scaled by zs -> the
    projective coordinate columns [xs, ys, zs]."""
    cols = [[], [], []]
    for P, z in zip(pts, zs):
        xyz = ((H.zero(), H.one(), H.zero()) if P is None
               else (H.mul(P[0], z), H.mul(P[1], z), z))
        for col, v in zip(cols, xyz):
            col.append(v)
    return cols


@pytest.mark.parametrize("W,c", [(5, 2), (5, 3), (8, 2), (8, 3)])
def test_scan_plain_matches_per_step_loop(toy, W, c):
    E, G = toy
    F = G.F
    rng = np.random.default_rng(40 + 10 * W + c)
    pts = [E.mul(int(k), GEN_TOY) for k in rng.integers(1, N_TOY, size=W)]
    pts[0] = pts[W - 2] = None
    zs = [int(z) for z in rng.integers(1, P_TOY, size=W)]
    T = [F.from_ints(col, "cpu") for col in _proj_cols(E.F, pts, zs)]
    got = horner_scan(G, T, c)                 # CPU: the plain version
    for g, w, p in zip(got, _loop(G, ProjectivePoint(*T), c),
                       horner_scan_plain(G, T, c)):
        assert g.shape == (F.n32,)
        assert torch.equal(g, w) and torch.equal(g, p)
    want = None
    for w, P in enumerate(pts):
        want = E.add(want, E.mul(1 << (c * w), P))
    X, Y, Z = (F.to_host(g) for g in got)
    if want is None:
        assert Z == 0
    else:
        zi = pow(Z, -1, P_TOY)
        assert (X * zi % P_TOY, Y * zi % P_TOY) == want


def _golden_inputs(cd, group: str):
    """W = 4 projective totals of alt_bn128 `group`, window 2 the
    identity, the others k * gen for random k, scaled by random z."""
    g = getattr(cd, group)
    E, H = g.curve, g.curve.F
    rng = np.random.default_rng(31 if group == "g1" else 32)
    pts = [E.mul(int(k), g.generator)
           for k in rng.integers(1, 1 << 62, size=4)]
    pts[2] = None

    def rand():
        v = [int(x) for x in rng.integers(1, 1 << 62, size=2)]
        return v[0] if group == "g1" else tuple(v)

    return _proj_cols(H, pts, [rand() for _ in pts])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scan_plain_matches_jax_golden(group):
    gold = json.loads(GOLDEN.read_text())[group]
    G = getattr(device_curve("alt_bn128"), group)
    F = G.F

    def field(col):
        if F.el_ndim == 1:
            return F.from_ints(col, "cpu")
        return F.from_host_batch([tuple(v) for v in col], "cpu")

    T = [field(col) for col in gold["totals"]]
    got = horner_scan(G, T, gold["c"])
    host = [F.to_host(g) for g in got]
    want = [v if F.el_ndim == 1 else tuple(v) for v in gold["sum"]]
    assert host == want


@pytest.mark.parametrize("op", sorted(OPS))
def test_pair_schedule_matches_plain(op):
    """K3's G2 branch as fp2_pair.cuh schedules it, on 400 alt_bn128
    elements with k3_inputs' edge lanes (P = 0, Q = 0, Q = P, Q = -P, Q =
    P rescaled, Q at infinity)."""
    G = device_curve("alt_bn128").g2
    c, cm, q_inf = k3_inputs(G.F, 400, np.random.default_rng(41), "cpu")
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    for g, w in zip(group_op_pair_plain(G, op, coords, masks),
                    group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["count", "c", "shape", "empty"])
def test_scan_rejects(toy, case):
    _, G = toy
    F = G.F
    T = [F.from_ints([1, 2, 3], "cpu") for _ in range(3)]
    c = 2
    if case == "count":
        T = T[:2]
    elif case == "c":
        c = -1
    elif case == "shape":
        T[1] = F.from_ints([1, 2], "cpu")
    else:
        T = [t[:, :0] for t in T]
    with pytest.raises(ValueError):
        horner_scan(G, T, c)


def _write_golden() -> None:
    """The golden of test_scan_plain_matches_jax_golden, from the JAX
    package's _horner_complete through its scan branch."""
    from libff_tpu.curves.device import device_curve as jax_device_curve
    from libff_tpu.curves.group import ProjectivePoint as JaxProjective
    from libff_tpu.msm.pippenger import _horner_complete

    jdc = jax_device_curve("alt_bn128")
    cd = device_curve("alt_bn128").cd
    out = {}
    for group in ("g1", "g2"):
        JG = getattr(jdc, group)
        cols = _golden_inputs(cd, group)
        T = JaxProjective(*(JG.F.from_host_batch(col) for col in cols))
        S = _horner_complete(JG, T, 2, direct="scan")
        out[group] = {"W": 4, "c": 2, "totals": cols,
                      "sum": [JG.F.to_host(a) for a in S]}
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
