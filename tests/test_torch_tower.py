"""The port's Fq2 field and the plain version of kernel K4 against the JAX
package and the host oracle, bit for bit.

On CPU tensors ``libff_tpu_torch.fields.tower.ExtField`` runs the plain
version of K4 (the JAX formulas over the plain prime field in 16-bit
limbs); its canonical residues must equal the JAX package's ``ExtField``
after the limb repack, and the host ``hf.Ext`` values.  Two fields:
alt_bn128's Fq2 (nr = p - 1) and the toy Fq2 of
tests/test_pallas_interpret.py (p = 65539, nr = 2).  Inputs are 16
elements whose coefficients include 0, 1 and p - 1, made from a numpy
seed.  JAX runs eagerly; its inverse and batch inverse take seconds to
half a minute on the CPU, so the inverse is held against JAX on the toy
field and both against the host oracle on both fields.  All comparisons
are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libff_tpu.curves.device import device_curve as jax_device_curve
from libff_tpu.fields.fp import PrimeField as JaxPrimeField
from libff_tpu.fields.tower import ExtField as JaxExtField
from libff_tpu.host import field as hf
from libff_tpu.msm.pallas_insert import _KernelField2
from libff_tpu_torch import convert
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.fields.fp import PrimeField, to16, to32
from libff_tpu_torch.fields.tower import ExtField, fq2_op, fq2_op_plain
from tests.test_pallas_interpret import NR_TOY, P_TOY

torch.set_num_threads(1)

N = 16


def _values(p: int, seed: int) -> list[tuple]:
    """Every pair of coefficients from {0, 1, p - 1}, then random pairs."""
    rng = np.random.default_rng(seed)
    edges = [(x, y) for x in (0, 1, p - 1) for y in (0, 1, p - 1)]
    rand = [tuple(int.from_bytes(rng.bytes(40), "little") % p
                  for _ in range(2)) for _ in range(N - len(edges))]
    return edges + rand


@pytest.fixture(scope="module", params=["alt_bn128", "toy"])
def fq2(request):
    """(host Ext, JAX ExtField, port ExtField, a values, b values)."""
    if request.param == "alt_bn128":
        H = jax_device_curve("alt_bn128").cd.fq2
        JF = jax_device_curve("alt_bn128").fq2
        TF = device_curve("alt_bn128").fq2
    else:
        H = hf.Ext(hf.Fp(P_TOY, name="toy_Fp"), 2, NR_TOY, name="toy_Fp2")
        JF = JaxExtField(JaxPrimeField(P_TOY, name="toy_Fp"), H)
        TF = ExtField(PrimeField(P_TOY, name="toy_Fp"), H)
    p = H.p
    return H, JF, TF, _values(p, 61), _values(p, 62)[::-1]


def _same(port: torch.Tensor, jax_arr) -> bool:
    return torch.equal(port, convert.field_to_torch(np.asarray(jax_arr),
                                                    "cpu", el_ndim=2))


def _port(TF, vals):
    return TF.from_host_batch(vals, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_op_matches_jax_and_host(fq2, op):
    H, JF, TF, va, vb = fq2
    got = getattr(TF, op)(_port(TF, va), _port(TF, vb))
    assert _same(got, getattr(JF, op)(JF.from_host_batch(va),
                                      JF.from_host_batch(vb)))
    assert TF.to_host_batch(got) == [getattr(H, op)(x, y)
                                     for x, y in zip(va, vb)]


@pytest.mark.parametrize("op", ["neg", "sqr", "double"])
def test_unary_op_matches_jax_and_host(fq2, op):
    H, JF, TF, va, _ = fq2
    got = getattr(TF, op)(_port(TF, va))
    assert _same(got, getattr(JF, op)(JF.from_host_batch(va)))
    assert TF.to_host_batch(got) == [getattr(H, op)(x) for x in va]


def test_inv_matches_jax_and_host(fq2):
    """(a0 - a1 u) / (a0^2 - nr a1^2) with one base-field Fermat inverse;
    0 maps to 0."""
    H, JF, TF, va, _ = fq2
    got = TF.inv(_port(TF, va))
    if H.p == P_TOY:
        assert _same(got, JF.inv(JF.from_host_batch(va)))
    assert TF.to_host_batch(got) == [
        H.zero() if H.is_zero(x) else H.inv(x) for x in va]


def test_batch_inverse(fq2):
    """Montgomery-trick inversion along the batch axis, zeros through as
    zeros, against the host oracle."""
    H, _, TF, va, _ = fq2
    got = TF.batch_inverse(_port(TF, va))
    assert TF.to_host_batch(got) == [
        H.zero() if H.is_zero(x) else H.inv(x) for x in va]
    # along either batch axis of a (2, n32, 4, 4) array
    a = _port(TF, va).reshape(TF.el_shape + (4, 4))
    assert torch.equal(TF.batch_inverse(a, axis=2).reshape(got.shape), got)
    with pytest.raises(ValueError):
        TF.batch_inverse(a, axis=1)


def test_mul_small_const_matches_jax(fq2):
    """Host Fq2 constants: a small one with c1 != 0 (addition chains) and
    3b' of alt_bn128's twist (a general Fq2 element)."""
    H, JF, TF, va, _ = fq2
    b3 = jax_device_curve("alt_bn128").g2._b3_host
    for c in [(H.p - 1, 2), tuple(v % H.p for v in b3)]:
        got = TF.mul_small_const(_port(TF, va), c)
        assert _same(got, JF.mul_small_const(JF.from_host_batch(va), c))
        assert TF.to_host_batch(got) == [H.mul(x, c) for x in va]


def test_constructors_predicates_and_host_conversion(fq2):
    H, JF, TF, va, vb = fq2
    a = _port(TF, va)
    assert a.shape == (2, TF.n32, N) and a.dtype == torch.int32
    assert _same(a, JF.from_host_batch(va))
    assert TF.to_host(TF.from_host(va[11], "cpu")) == va[11]
    assert TF.to_host_batch(TF.one((3,), "cpu")) == [H.one()] * 3
    assert TF.to_host_batch(TF.zero((2,), "cpu")) == [H.zero()] * 2
    assert TF.is_zero(a).tolist() == [H.is_zero(x) for x in va]
    assert TF.eq(a, _port(TF, vb)).tolist() == [x == y for x, y in
                                                zip(va, vb)]
    mask = torch.tensor([True, False] * (N // 2))
    assert _same(TF.select(mask, a, _port(TF, vb)),
                 JF.select(jnp.asarray(mask.numpy()), JF.from_host_batch(va),
                           JF.from_host_batch(vb)))
    assert TF.mont_limbs(va[12])[:TF.n32] == TF.B.mont_limbs(va[12][0])


def test_k4_plain_layer_matches_kernel_field2():
    """The plain version of K4 (Karatsuba mul, complex sqr) against the
    Pallas kernels' in-kernel Fq2 layer, called eagerly on toy tiles."""
    H = hf.Ext(hf.Fp(P_TOY, name="toy_Fp"), 2, NR_TOY, name="toy_Fp2")
    JF = JaxExtField(JaxPrimeField(P_TOY, name="toy_Fp"), H)
    TF = ExtField(PrimeField(P_TOY, name="toy_Fp"), H)
    kf = _KernelField2(JF)
    va, vb = _values(P_TOY, 63), _values(P_TOY, 64)
    ja, jb = JF.from_host_batch(va), JF.from_host_batch(vb)
    a, b = _port(TF, va), _port(TF, vb)
    for got, want in ((fq2_op(TF, "mul", a, b), kf.mul((ja[0], ja[1]),
                                                        (jb[0], jb[1]))),
                      (fq2_op(TF, "sqr", a, a), kf.sqr((ja[0], ja[1])))):
        assert _same(got, jnp.stack(want))
    # the layer works on 16-bit limbs of the (2, n16, ...) layout
    assert torch.equal(to32(TF.plain.mul(to16(a, 1), to16(b, 1)), 1),
                       fq2_op_plain(TF, "mul", a, b))


@pytest.mark.parametrize("case", ["shape", "dtype", "device", "op"])
def test_k4e_wrapper_rejects(case):
    """The wrapper raises on what K4e does not take; a tensor on a device
    with no kernel is refused, never computed on the CPU."""
    TF = device_curve("alt_bn128").fq2
    a = TF.from_host_batch([(1, 2), (3, 4)], "cpu")
    b, op = a.clone(), "mul"
    if case == "shape":
        b = a[..., :1]
    elif case == "dtype":
        b = b.to(torch.int64)
    elif case == "device":
        a, b = a.to("meta"), b.to("meta")
    else:
        op = "div"
    with pytest.raises((ValueError, TypeError)):
        fq2_op(TF, op, a, b)
