"""Kernel K3's plain version and the port's Group against the JAX package.

``group_op`` on CPU tensors runs the plain version of K3 (formulas.py over
the plain field, with the kernel's masks).  It must give the coordinates
of the JAX package's Pallas kernel ``group_op_pallas`` bit for bit; the
JAX side runs the kernel body through ``interpret="reference"``, as
tests/test_pallas_interpret.py does.  The batch (N = 1024) lies on the toy
curve of that file (p = 65539, b = 11, prime order 65287) and holds the
edge lanes P = 0, Q = 0, P = Q, P = -Q and P = Q in another scaling.  One
alt_bn128 case of 8 elements holds ``padd`` against JAX ``Group.padd``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libff_tpu.curves.device import device_curve as jax_device_curve
from libff_tpu.curves.group import Group as JaxGroup
from libff_tpu.curves.group import ProjectivePoint as JaxProjective
from libff_tpu.curves.pallas_ops import group_op_pallas
from libff_tpu.fields.fp import PrimeField as JaxPrimeField
from libff_tpu.host import ec as hec
from libff_tpu.host import field as hf
from libff_tpu_torch import convert
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import (AffinePoint, Group,
                                          JacobianPoint, ProjectivePoint)
from libff_tpu_torch.curves.group_ops import group_op, group_op_plain
from libff_tpu_torch.fields.fp import PrimeField
from tests.test_pallas_interpret import B_TOY, GEN_TOY, N_TOY, P_TOY, _gdef

torch.set_num_threads(1)

N = 1024


@pytest.fixture(scope="module")
def toy():
    Fh = hf.Fp(P_TOY, name="toy_Fp")
    E = hec.WeierstrassCurve(Fh, 0, B_TOY, name="toy_E")
    gdef = _gdef(E, GEN_TOY, N_TOY)
    JG = JaxGroup(JaxPrimeField(P_TOY, name="toy_Fp"), gdef)
    TG = Group(PrimeField(P_TOY, name="toy_Fp"), gdef)
    return E, JG, TG


def _jac(P, z, p):
    """Host affine point -> Jacobian (x z^2, y z^3, z); None -> (0, 1, 0)."""
    if P is None:
        return (0, 1, 0)
    return (P[0] * z * z % p, P[1] * z ** 3 % p, z)


def _proj(P, z, p):
    """Host affine point -> projective (x z, y z, z); None -> (0, 1, 0)."""
    if P is None:
        return (0, 1, 0)
    return (P[0] * z % p, P[1] * z % p, z)


@pytest.fixture(scope="module")
def lanes(toy):
    """Host points P_i, Q_i and scalings with the edge lanes:
    [0, 64) P = 0, [64, 128) Q = 0, [128, 192) Q = P, [192, 256) Q = -P,
    [256, 320) Q = P in another scaling, [1024 - 76, 1024) Q's affine
    infinity flag set; the rest random."""
    E, _, _ = toy
    p = P_TOY
    rng = np.random.default_rng(21)
    ks = rng.integers(1, N_TOY, size=(2, N))
    P = [E.mul(int(k), GEN_TOY) for k in ks[0]]
    Q = [E.mul(int(k), GEN_TOY) for k in ks[1]]
    zp = [int(z) for z in rng.integers(1, p, size=N)]
    zq = [int(z) for z in rng.integers(1, p, size=N)]
    for i in range(0, 64):
        P[i] = None
    for i in range(64, 128):
        Q[i] = None
    for i in range(128, 192):
        Q[i], zq[i] = P[i], zp[i]
    for i in range(192, 256):
        Q[i], zq[i] = E.neg(P[i]), zp[i]
    for i in range(256, 320):
        Q[i] = P[i]
    q_inf = np.array([Q[i] is None or i >= N - 76 for i in range(N)])
    return P, Q, zp, zq, q_inf


def _inputs(op, toy, lanes):
    """Host coordinate lists and the mask list for one op."""
    P, Q, zp, zq, q_inf = lanes
    p = P_TOY
    conv = _jac if op in ("add", "madd", "dbl") else _proj
    pc = [conv(a, z, p) for a, z in zip(P, zp)]
    qc = [conv(a, z, p) for a, z in zip(Q, zq)]
    # affine Q for the mixed adds; its infinity lanes carry (0, 0)
    qa = [(0, 0, 1) if (a is None or q_inf[i]) else (a[0], a[1], 1)
          for i, a in enumerate(Q)]
    cols = [[c[j] for c in pc] for j in range(3)]
    if op in ("padd", "add"):
        cols += [[c[j] for c in qc] for j in range(3)]
    elif op in ("pmadd", "madd"):
        cols += [[c[j] for c in qa] for j in range(2)]
    masks = [q_inf] if op in ("pmadd", "madd") else []
    return cols, masks


@pytest.mark.parametrize("op", ["padd", "pmadd", "pdbl", "add", "madd", "dbl"])
def test_group_op_plain_matches_pallas_kernel(toy, lanes, op):
    E, JG, TG = toy
    cols, masks = _inputs(op, toy, lanes)
    want = group_op_pallas(JG, op, [JG.F.from_ints(c) for c in cols],
                           [jnp.asarray(m) for m in masks],
                           interpret="reference")
    got = group_op(TG, op, [TG.F.from_ints(c, "cpu") for c in cols],
                   [torch.from_numpy(m) for m in masks])
    for g, w in zip(got, want):
        assert torch.equal(g, convert.field_to_torch(np.asarray(w), "cpu"))
    # the group value, too: the result is the host sum (or double)
    F = TG.F
    X, Y, Z = (F.to_ints(g) for g in got)
    P, Q, _, _, q_inf = lanes
    jac = op in ("add", "madd", "dbl")
    for i in range(0, N, 7):
        if op in ("pdbl", "dbl"):
            ref = E.dbl(P[i])
        else:
            ref = E.add(P[i], None if q_inf[i] and op in ("pmadd", "madd")
                        else Q[i])
        if ref is None:
            assert Z[i] == 0
        else:
            zi = pow(Z[i], -1, P_TOY)
            sx, sy = (zi * zi, zi ** 3) if jac else (zi, zi)
            assert (X[i] * sx % P_TOY, Y[i] * sy % P_TOY) == ref


def test_padd_alt_bn128_matches_jax_group():
    """8 elements of alt_bn128 G1 through the port's Group.padd (K3's plain
    version) and the JAX package's Group.padd (its formula VM)."""
    jdc, tdc = jax_device_curve("alt_bn128"), device_curve("alt_bn128")
    cd = tdc.cd
    E, gen, q = cd.g1.curve, cd.g1.generator, cd.q
    rng = np.random.default_rng(22)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=16)]
    pts = [E.mul(k, gen) for k in ks]
    zs = [int(z) for z in rng.integers(1, 1 << 62, size=16)]
    pts[1] = None                                     # P = 0
    pts[8 + 2] = None                                 # Q = 0
    pts[8 + 3], zs[8 + 3] = pts[3], zs[3]             # Q = P
    pts[8 + 4] = E.neg(pts[4])                        # Q = -P
    coords = [_proj(a, z, q) for a, z in zip(pts, zs)]
    cols = [[c[j] for c in coords] for j in range(3)]
    jP = JaxProjective(*(jdc.fq.from_ints(c[:8]) for c in cols))
    jQ = JaxProjective(*(jdc.fq.from_ints(c[8:]) for c in cols))
    tP = ProjectivePoint(*(tdc.fq.from_ints(c[:8], "cpu") for c in cols))
    tQ = ProjectivePoint(*(tdc.fq.from_ints(c[8:], "cpu") for c in cols))
    want = jdc.g1.padd(jP, jQ)
    got = tdc.g1.padd(tP, tQ)
    for g, w in zip(got, want):
        assert torch.equal(g, convert.field_to_torch(np.asarray(w), "cpu"))


# -- the port's Group around K3, against the host curve --------------------------

def _host_affine(F, A: AffinePoint):
    xs, ys = F.to_ints(A.x), F.to_ints(A.y)
    return [None if bool(i) else (x, y)
            for x, y, i in zip(xs, ys, A.inf.reshape(-1).tolist())]


def test_to_affine_and_coordinate_maps(toy, lanes):
    E, _, TG = toy
    F = TG.F
    P, _, zp, _, _ = lanes
    pts, zs = P[56:72], zp[56:72]                       # 8 zeros, 8 points
    proj = [_proj(a, z, P_TOY) for a, z in zip(pts, zs)]
    Pp = ProjectivePoint(*(F.from_ints([c[j] for c in proj], "cpu")
                           for j in range(3)))
    J = TG.proj_to_jacobian(Pp)
    assert isinstance(J, JacobianPoint)
    assert _host_affine(F, TG.to_affine(J)) == pts
    # a single element takes the Fermat inverse
    single = JacobianPoint(*(c[:, 9] for c in J))
    assert _host_affine(F, TG.to_affine(single)) == [pts[9]]
    # affine -> Jacobian / projective keep the value; infinity -> (0, 1, 0)
    A = TG.to_affine(J)
    for conv in (TG.from_affine, TG.proj_from_affine):
        R = conv(A)
        z = F.to_ints(R.z)
        assert [F.to_ints(R.y)[i] for i in range(8)] == [1] * 8
        assert z[:8] == [0] * 8 and all(v == 1 for v in z[8:])
    assert TG.is_zero(J).tolist() == [a is None for a in pts]


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_proj_sum_tree_pads_with_identity(toy, lanes, n):
    E, _, TG = toy
    F = TG.F
    P, _, zp, _, _ = lanes
    pts, zs = P[60:60 + n], zp[60:60 + n]
    proj = [_proj(a, z, P_TOY) for a, z in zip(pts, zs)]
    Pp = ProjectivePoint(*(F.from_ints([c[j] for c in proj], "cpu")
                           .reshape(F.n32, 1, n) for j in range(3)))
    S = TG.proj_sum_tree(Pp, axis=-1)
    assert S.z.shape == (F.n32, 1)
    want = None
    for a in pts:
        want = E.add(want, a)
    got = TG.to_affine(TG.proj_to_jacobian(S))
    assert _host_affine(F, got) == [want]


def test_select_and_identity(toy):
    _, _, TG = toy
    F = TG.F
    A = AffinePoint(F.from_ints([GEN_TOY[0]] * 4, "cpu"),
                    F.from_ints([GEN_TOY[1]] * 4, "cpu"),
                    torch.zeros(4, dtype=torch.bool))
    Z = TG.proj_zero((4,), "cpu")
    assert (F.to_ints(Z.x), F.to_ints(Z.y)) == ([0] * 4, [1] * 4)
    mask = torch.tensor([True, False, True, False])
    S = TG.select(mask, TG.proj_from_affine(A), Z)
    assert F.to_ints(S.z) == [1, 0, 1, 0]
    assert F.to_ints(A.x) == [GEN_TOY[0]] * 4
    Sa = TG.select(mask, A, AffinePoint(A.x, A.y, ~A.inf))
    assert Sa.inf.tolist() == [False, True, False, True]


@pytest.mark.parametrize("case", ["op", "count", "shape", "mask", "device"])
def test_k3_wrapper_rejects(toy, case):
    _, _, TG = toy
    F = TG.F
    c = [F.from_ints([1, 2, 3], "cpu") for _ in range(6)]
    op, masks = "padd", []
    if case == "op":
        op = "psub"
    elif case == "count":
        c = c[:5]
    elif case == "shape":
        c[4] = F.from_ints([1, 2], "cpu")
    elif case == "mask":
        op, c, masks = "pmadd", c[:5], [torch.zeros(3, dtype=torch.int32)]
    else:
        c = [a.to("meta") for a in c]
    with pytest.raises((ValueError, TypeError)):
        group_op(TG, op, c, masks)
    if case != "device":
        with pytest.raises((ValueError, TypeError)):
            group_op_plain(TG, op, c, masks)
