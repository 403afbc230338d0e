"""The G2 slice on the CPU: kernels K3 and K2 at k = 2 (their plain
versions), the G2 MSM, and the conversion of Fq2 arrays and G2 points.

K3: ``group_op`` on CPU tensors runs the plain version (formulas.py over
the plain Fq2 field); it must give the coordinates of the JAX package's
Pallas kernel ``group_op_pallas`` bit for bit, its k = 2 body run through
``interpret="reference"``, on the toy G2 of tests/test_pallas_interpret.py
(Fq2 over p = 65539 with nr = 2, b = (11, 0)) at N = 1024 with the edge
lanes P = 0, Q = 0, P = Q, P = -Q and P = Q in another scaling.  The toy
b3 is (33, 0); alt_bn128's twist b3 = 3b' has c1 != 0, so padd and pmadd
also run on 8 alt_bn128 G2 elements against the host curve.
K2: ``insert`` on CPU tensors against ``insert_pallas3`` (k = 2, packed,
merge=False) on the toy G2 context ``g2ctx``, raw buckets bit for bit.
The slice: ``msm_pippenger`` on alt_bn128 G2 at 2^8 points against the
structured oracle of profile/bench_g2.py, and on the toy G2 against the
host ``E.msm``.  All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libff_tpu.curves.pallas_ops import group_op_pallas
from libff_tpu.msm.pallas_insert3 import insert_pallas3
from libff_tpu_torch import convert, workload
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import (AffinePoint, Group,
                                          ProjectivePoint)
from libff_tpu_torch.curves.group_ops import group_op
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.fields.tower import ExtField
from libff_tpu_torch.msm.insert import insert
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger
from tests.test_pallas_interpret import N_TOY, P_TOY, g2ctx  # noqa: F401

torch.set_num_threads(1)

N = 1024


def _port_group(jax_group) -> Group:
    """The port's Group over the same host toy Fq2 and GroupDef."""
    return Group(ExtField(PrimeField(P_TOY, name="toy_Fp"), jax_group.F.h),
                 jax_group.gdef)


@pytest.fixture(scope="module")
def toy2(g2ctx):  # noqa: F811
    """(host curve, JAX group, port group) of the toy G2."""
    JG, E2 = g2ctx[0], g2ctx[1]
    return E2, JG, _port_group(JG)


def _scale(H, P, z, jac):
    """Host affine point -> Jacobian (x z^2, y z^3, z) or projective
    (x z, y z, z); None -> (0, 1, 0)."""
    if P is None:
        return (H.zero(), H.one(), H.zero())
    zx = H.sqr(z) if jac else z
    zy = H.mul(zx, z) if jac else z
    return (H.mul(P[0], zx), H.mul(P[1], zy), z)


@pytest.fixture(scope="module")
def lanes(toy2):
    """Host points P_i, Q_i of the toy G2 and scalings with the edge lanes:
    [0, 64) P = 0, [64, 128) Q = 0, [128, 192) Q = P, [192, 256) Q = -P,
    [256, 320) Q = P in another scaling, [N - 76, N) Q's affine infinity
    flag set; the rest the points (a + i*s) * gen and (b + i*t) * gen for
    random a, s, b, t."""
    E2, JG, _ = toy2
    H, gen = E2.F, JG.gdef.generator
    rng = np.random.default_rng(71)
    a, s, b, t = (int(k) for k in rng.integers(1, N_TOY, size=4))

    def progression(start, step):
        S, out = E2.mul(step, gen), [E2.mul(start, gen)]
        while len(out) < N:
            out.append(E2.add(out[-1], S))
        return out

    P, Q = progression(a, s), progression(b, t)
    zs = rng.integers(1, P_TOY, size=(2, N, 2))
    zp = [(int(a), int(b)) for a, b in zs[0]]
    zq = [(int(a), int(b)) for a, b in zs[1]]
    for i in range(0, 64):
        P[i] = None
    for i in range(64, 128):
        Q[i] = None
    for i in range(128, 192):
        Q[i], zq[i] = P[i], zp[i]
    for i in range(192, 256):
        Q[i], zq[i] = E2.neg(P[i]), zp[i]
    for i in range(256, 320):
        Q[i] = P[i]
    q_inf = np.array([Q[i] is None or i >= N - 76 for i in range(N)])
    return P, Q, zp, zq, q_inf


def _inputs(op, H, lanes):
    """Host coordinate columns and the mask list for one op."""
    P, Q, zp, zq, q_inf = lanes
    jac = op in ("add", "madd", "dbl")
    pc = [_scale(H, a, z, jac) for a, z in zip(P, zp)]
    qc = [_scale(H, a, z, jac) for a, z in zip(Q, zq)]
    # affine Q for the mixed adds; its infinity lanes carry (0, 0)
    qa = [(H.zero(), H.zero()) if (a is None or q_inf[i]) else a
          for i, a in enumerate(Q)]
    cols = [[c[j] for c in pc] for j in range(3)]
    if op in ("padd", "add"):
        cols += [[c[j] for c in qc] for j in range(3)]
    elif op in ("pmadd", "madd"):
        cols += [[c[j] for c in qa] for j in range(2)]
    masks = [q_inf] if op in ("pmadd", "madd") else []
    return cols, masks


@pytest.mark.parametrize("op", ["padd", "pmadd", "pdbl", "add", "madd", "dbl"])
def test_k3_k2_plain_matches_pallas_kernel(toy2, lanes, op):
    E2, JG, TG = toy2
    cols, masks = _inputs(op, E2.F, lanes)
    want = group_op_pallas(JG, op, [JG.F.from_host_batch(c) for c in cols],
                           [jnp.asarray(m) for m in masks],
                           interpret="reference")
    got = group_op(TG, op, [TG.F.from_host_batch(c, "cpu") for c in cols],
                   [torch.from_numpy(m) for m in masks])
    for g, w in zip(got, want):
        assert g.shape == (2, TG.F.n32, N)
        assert torch.equal(g, convert.field_to_torch(np.asarray(w), "cpu", 2))


def _host_affine(G, A: AffinePoint):
    xs, ys = G.F.to_host_batch(A.x), G.F.to_host_batch(A.y)
    return [None if bool(i) else (x, y)
            for x, y, i in zip(xs, ys, A.inf.reshape(-1).tolist())]


@pytest.mark.parametrize("op", ["padd", "pmadd"])
def test_alt_bn128_g2_ops_match_host(op):
    """8 alt_bn128 G2 elements, whose b3 = 3b' is a general Fq2 constant,
    through K3's plain version, against the host curve; P = 0, Q = 0,
    P = Q, P = -Q and Q at infinity among them."""
    dc = device_curve("alt_bn128")
    G, cd = dc.g2, dc.cd
    E, gen, H = cd.g2.curve, cd.g2.generator, cd.fq2
    rng = np.random.default_rng(72)
    P = [E.mul(int(k), gen) for k in rng.integers(1, 1 << 62, size=8)]
    Q = [E.mul(int(k), gen) for k in rng.integers(1, 1 << 62, size=8)]
    P[1], Q[2], Q[3], Q[4] = None, None, P[3], E.neg(P[4])
    zs = [tuple(int(v) for v in rng.integers(1, 1 << 62, size=2))
          for _ in range(16)]
    pc = [_scale(H, a, z, False) for a, z in zip(P, zs[:8])]
    Pp = ProjectivePoint(*(G.F.from_host_batch([c[j] for c in pc], "cpu")
                           for j in range(3)))
    if op == "padd":
        qc = [_scale(H, a, z, False) for a, z in zip(Q, zs[8:])]
        R = G.padd(Pp, ProjectivePoint(*(
            G.F.from_host_batch([c[j] for c in qc], "cpu") for j in range(3))))
        want = [E.add(a, b) for a, b in zip(P, Q)]
    else:
        inf = [q is None for q in Q]
        qa = [(H.zero(), H.zero()) if q is None else q for q in Q]
        R = G.pmadd(Pp, AffinePoint(
            G.F.from_host_batch([q[0] for q in qa], "cpu"),
            G.F.from_host_batch([q[1] for q in qa], "cpu"), torch.tensor(inf)))
        want = [a if i else E.add(a, b) for a, b, i in zip(P, Q, inf)]
    assert _host_affine(G, G.to_affine(G.proj_to_jacobian(R))) == want


def test_k2_k2_plain_matches_pallas_kernel(g2ctx):  # noqa: F811
    """The raw G2 buckets of the port's insert equal the TPU kernel's."""
    JG, _, jd, jpts, B, _ = g2ctx
    TG = _port_group(JG)
    want = insert_pallas3(JG, jd, jpts, B, packed=True, merge=False,
                          interpret="reference")
    td = torch.from_numpy(np.array(jd))
    tpts = tuple(convert.field_to_torch(np.asarray(a), "cpu", 2)
                 for a in jpts[:3]) + (torch.from_numpy(np.array(jpts[3])),)
    got = insert(TG, td, tpts, B)
    W, T, L = td.shape
    for g, w in zip(got, want):
        assert g.shape == (2, TG.F.n32, W, B, L)
        assert torch.equal(g, convert.field_to_torch(np.asarray(w), "cpu", 2))


def test_alt_bn128_g2_msm_matches_oracle():
    """The G2 path's curve and input structure (bench_g2.py:49-85) at 2^8
    points against the structured oracle."""
    dc = device_curve("alt_bn128")
    s, A, want = workload.msm_case(dc, "g2", 8, "cpu", 73)
    got, _, _ = workload.run_msm(dc.g2, s, A, MsmConfig(c=5, lanes=16))
    assert got == want


def test_toy_g2_msm_matches_host(toy2):
    """Random scalars below the order and distinct points, one at
    infinity, against the host E.msm."""
    E2, JG, TG = toy2
    rng = np.random.default_rng(74)
    n = 96
    ks = [int(k) for k in rng.integers(0, N_TOY, size=n)]
    pts = [E2.mul(int(k), JG.gdef.generator)
           for k in rng.integers(1, N_TOY, size=n)]
    inf = np.zeros(n, dtype=bool)
    inf[n // 3] = True
    limbs = np.zeros((4, n), dtype=np.uint32)
    limbs[0] = [k & 0xFFFF for k in ks]
    limbs[1] = [k >> 16 for k in ks]
    A = AffinePoint(TG.F.from_host_batch([p[0] for p in pts], "cpu"),
                    TG.F.from_host_batch([p[1] for p in pts], "cpu"),
                    torch.from_numpy(inf))
    R = msm_pippenger(TG, convert.field_to_torch(limbs, "cpu"), A,
                      N_TOY.bit_length(), config=MsmConfig(c=4, lanes=16))
    live = [i for i in range(n) if not inf[i]]
    want = E2.msm([ks[i] for i in live], [pts[i] for i in live])
    assert _host_affine(TG, TG.to_affine(R)) == [want]


def test_workload_g2_inputs():
    """The G2 inputs: points the 16 generator multiples in the JAX Fq2
    layout (2, n16, N), Montgomery form, period 16."""
    dc = device_curve("alt_bn128")
    cd = dc.cd
    limbs, x, y = workload.msm_inputs(cd, 40, 75, "g2")
    assert x.shape == (2, 16, 40) and y.shape == (2, 16, 40)
    gen3 = cd.g2.curve.mul(3, cd.g2.generator)
    F = dc.fq2
    assert F.to_host(convert.field_to_torch(x[..., 18], "cpu", 2)) == gen3[0]
    assert F.to_host(convert.field_to_torch(y[..., 2], "cpu", 2)) == gen3[1]
    assert workload.class_sums(limbs, 16)[5] == sum(
        int.from_bytes(limbs[:, i].astype("<u2").tobytes(), "little")
        for i in (5, 21, 37))


def test_convert_fq2_and_g2_points(toy2):
    """Fq2 arrays and G2 points: JAX (2, n16, *batch) <-> port (2, n32,
    *batch), both ways, equal to the JAX package's own arrays."""
    dc = device_curve("alt_bn128")
    F = dc.fq2
    rng = np.random.default_rng(76)
    coords = [rng.integers(0, 1 << 16, size=(2, 16, 3, 5), dtype=np.uint32)
              for _ in range(3)]
    t = convert.field_to_torch(coords[0], "cpu", 2)
    assert t.shape == (2, 8, 3, 5) and t.dtype == torch.int32
    assert np.array_equal(convert.field_from_torch(t, 2), coords[0])
    # a layout that does not match el_ndim is refused, not repacked
    for arr, nd in ((coords[0], 1), (coords[0][0], 2)):
        with pytest.raises(ValueError):
            convert.field_to_torch(arr, "cpu", nd)
    with pytest.raises(ValueError):
        convert.field_from_torch(t[0], 2)
    inf =rng.random(5) < 0.5
    A = convert.affine_to_torch((coords[0][..., 0, :], coords[1][..., 0, :],
                                 inf), "cpu", 2)
    assert all(np.array_equal(a, b) for a, b in zip(
        convert.affine_from_torch(A, 2),
        (coords[0][..., 0, :], coords[1][..., 0, :], inf)))
    P = convert.point_to_torch(coords, ProjectivePoint, "cpu", 2)
    assert all(np.array_equal(a, b) for a, b in
               zip(convert.point_from_torch(P, 2), coords))
    # the JAX package's Fq2 array of the same values, repacked
    E2, JG, TG = toy2
    vals = [(1, 2), (P_TOY - 1, 0), (12345, 54321)]
    assert torch.equal(
        TG.F.from_host_batch(vals, "cpu"),
        convert.field_to_torch(np.asarray(JG.F.from_host_batch(vals)),
                               "cpu", 2))
    assert F.to_host_batch(F.from_host_batch([(5, 7)], "cpu")) == [(5, 7)]


@pytest.mark.parametrize("case", ["group", "insert"])
def test_k2_k3_wrappers_reject_other_groups(toy2, case):
    """The toy G2's nr = 2 and 1-limb field run only on the plain
    versions: on a CUDA tensor the wrappers refuse it.  Without a card
    the kernel branch is checked directly."""
    from libff_tpu_torch.curves.group_ops import kernel_branch

    _, _, TG = toy2
    with pytest.raises(NotImplementedError):
        kernel_branch(TG, "K3" if case == "group" else "K2")
    dc = device_curve("alt_bn128")
    assert kernel_branch(dc.g1, "K3")[:2] == (1, 9)
    k, _, b3 = kernel_branch(dc.g2, "K2")
    assert k == 2 and list(b3) == dc.fq2.mont_limbs(dc.g2._b3_host)
