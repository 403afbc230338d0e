"""The port's prime field against the JAX package's, bit for bit.

On CPU tensors ``libff_tpu_torch.fields.fp.PrimeField`` runs the plain
version of kernel K1 (int64 16-bit-limb CIOS); its canonical residues must
equal the JAX package's ``PrimeField`` (``mul_unrolled`` is the unrolled
``_cios`` that the Pallas kernels run) after the n16 -> n32 limb repack.
Inputs are 8 values per field, 0, 1 and p-1 among them, made from a numpy
seed; JAX runs eagerly on the CPU at that width.  All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libff_tpu.curves.device import device_curve as jax_device_curve
from libff_tpu_torch import convert
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import (AffinePoint, JacobianPoint,
                                          ProjectivePoint)
from libff_tpu_torch.fields import fp as tfp

torch.set_num_threads(1)

FIELDS = ("fq", "fr")


def _values(p: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1] + [int.from_bytes(rng.bytes(40), "little") % p
                            for _ in range(5)]


@pytest.fixture(scope="module")
def curves():
    return jax_device_curve("alt_bn128"), device_curve("alt_bn128")


@pytest.fixture(scope="module", params=FIELDS)
def field(request, curves):
    """(JAX field, port field, a values, b values) for one field."""
    jdc, tdc = curves
    JF, TF = getattr(jdc, request.param), getattr(tdc, request.param)
    va = _values(TF.p, 11)
    return JF, TF, va, _values(TF.p, 12)[::-1]


def _same(port: torch.Tensor, jax_arr) -> bool:
    return torch.equal(port, convert.field_to_torch(np.asarray(jax_arr),
                                                     "cpu"))


BINARY = {"add": ("add", "add"), "sub": ("sub", "sub"),
          "mul": ("mul", "mul_unrolled")}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches_jax(field, op):
    JF, TF, va, vb = field
    port_op, jax_op = BINARY[op]
    got = getattr(TF, port_op)(TF.from_ints(va, "cpu"),
                               TF.from_ints(vb, "cpu"))
    want = getattr(JF, jax_op)(JF.from_ints(va), JF.from_ints(vb))
    assert _same(got, want)
    p = TF.p
    host = {"add": lambda x, y: (x + y) % p, "sub": lambda x, y: (x - y) % p,
            "mul": lambda x, y: x * y % p}[op]
    assert TF.to_ints(got) == [host(x, y) for x, y in zip(va, vb)]


def test_neg_matches_jax(field):
    JF, TF, va, _ = field
    assert _same(TF.neg(TF.from_ints(va, "cpu")), JF.neg(JF.from_ints(va)))


def test_to_mont_matches_jax(field):
    JF, TF, va, _ = field
    got = TF.to_mont(TF.plain_from_ints(va, "cpu"))
    assert _same(got, JF.to_mont(JF.plain_from_ints(va)))
    assert _same(got, JF.from_ints(va))


def test_from_mont_matches_jax(field):
    JF, TF, va, _ = field
    got = TF.from_mont(TF.from_ints(va, "cpu"))
    assert _same(got, JF.from_mont(JF.from_ints(va)))
    assert TF.plain_to_ints(got) == va


def test_inv_matches_jax(field):
    JF, TF, va, _ = field
    got = TF.inv(TF.from_ints(va, "cpu"))
    assert _same(got, JF.inv(JF.from_ints(va)))
    assert TF.to_ints(got) == [pow(v, TF.p - 2, TF.p) for v in va]


def test_batch_inverse_matches_jax(curves):
    """Montgomery-trick batch inversion on Fq, the field the MSM's
    to_affine inverts in; zeros pass through as zeros."""
    jdc, tdc = curves
    JF, TF = jdc.fq, tdc.fq
    va = _values(TF.p, 13)
    got = TF.batch_inverse(TF.from_ints(va, "cpu"))
    assert _same(got, JF.batch_inverse(JF.from_ints(va)))


def test_batch_inverse_2d_axis(field):
    """Inversion along either batch axis of a (n32, 2, 4) array."""
    _, TF, va, _ = field
    a = TF.from_ints(va, "cpu").reshape(TF.n32, 2, 4)
    want = [pow(v, TF.p - 2, TF.p) for v in va]
    assert TF.to_ints(TF.batch_inverse(a, axis=-1)) == want
    assert TF.to_ints(TF.batch_inverse(a, axis=1)) == want
    with pytest.raises(ValueError):
        TF.batch_inverse(a, axis=0)


@pytest.mark.parametrize("c", [3, 9, -1, 1 << 100])
def test_mul_small_const_matches_jax(curves, c):
    jdc, tdc = curves
    JF, TF = jdc.fq, tdc.fq
    va = _values(TF.p, 14)
    got = TF.mul_small_const(TF.from_ints(va, "cpu"), c)
    assert _same(got, JF.mul_small_const(JF.from_ints(va), c))


def test_pow_static_and_predicates(field):
    JF, TF, va, vb = field
    a = TF.from_ints(va, "cpu")
    for e in (0, 1, 5, (1 << 64) + 3):
        assert TF.to_ints(TF.pow_static(a, e)) == [pow(v, e, TF.p) for v in va]
    b = TF.from_ints(vb, "cpu")
    assert torch.equal(TF.is_zero(a), torch.tensor([v == 0 for v in va]))
    assert torch.equal(TF.eq(a, a.clone()), torch.ones(8, dtype=torch.bool))
    mask = torch.tensor([True, False] * 4)
    jmask = jnp.asarray(mask.numpy())
    assert _same(TF.select(mask, a, b),
                 JF.select(jmask, JF.from_ints(va), JF.from_ints(vb)))
    assert TF.to_ints(TF.one((3,), "cpu")) == [1, 1, 1]
    assert TF.to_ints(TF.zero((2,), "cpu")) == [0, 0]


# -- the n16 <-> n32 repack and convert.py --------------------------------------

def test_repack_round_trip():
    rng = np.random.default_rng(5)
    a16 = rng.integers(0, 1 << 16, size=(16, 3, 7), dtype=np.uint32)
    a32 = convert.limbs16_to_32(a16)
    assert a32.shape == (8, 3, 7)
    assert np.array_equal(a32, a16[0::2] | (a16[1::2] << 16))
    assert np.array_equal(convert.limbs32_to_16(a32), a16)
    t = convert.field_to_torch(a16, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (8, 3, 7)
    assert np.array_equal(convert.field_from_torch(t), a16)
    # the plain field's int64 16-bit view is the same repack
    assert np.array_equal(tfp.to16(t).numpy().astype(np.uint32), a16)
    assert torch.equal(tfp.to32(tfp.to16(t)), t)


@pytest.mark.parametrize("bad", ["odd", "wide"])
def test_repack_rejects(bad):
    a = np.zeros((3, 4) if bad == "odd" else (4, 4), dtype=np.uint32)
    if bad == "wide":
        a[1, 2] = 1 << 16
    with pytest.raises(ValueError):
        convert.limbs16_to_32(a)


def test_montgomery_form_matches_jax(field):
    """from_ints gives the JAX package's Montgomery limbs, to_ints reads
    them back, and the plain forms agree too."""
    JF, TF, va, _ = field
    assert _same(TF.from_ints(va, "cpu"), JF.from_ints(va))
    assert _same(TF.plain_from_ints(va, "cpu"), JF.plain_from_ints(va))
    assert TF.to_ints(convert.field_to_torch(np.asarray(JF.from_ints(va)),
                                             "cpu")) == va
    assert TF.inv32 == (-pow(TF.p, -1, 1 << 32)) % (1 << 32)


def test_point_round_trips(curves):
    _, tdc = curves
    F = tdc.fq
    rng = np.random.default_rng(6)
    coords = [rng.integers(0, 1 << 16, size=(16, 5), dtype=np.uint32)
              for _ in range(3)]
    inf = np.array([False, True, False, False, True])
    A = convert.affine_to_torch((coords[0], coords[1], inf), "cpu")
    assert isinstance(A, AffinePoint) and A.x.shape == (F.n32, 5)
    back = convert.affine_from_torch(A)
    assert all(np.array_equal(x, y) for x, y in
               zip(back, (coords[0], coords[1], inf)))
    for kind in (ProjectivePoint, JacobianPoint):
        P = convert.point_to_torch(coords, kind, "cpu")
        assert isinstance(P, kind)
        assert all(np.array_equal(x, y) for x, y in
                   zip(convert.point_from_torch(P), coords))
    with pytest.raises(TypeError):
        convert.point_to_torch(coords, AffinePoint)


@pytest.mark.parametrize("case", ["shape", "dtype", "limbs", "device", "op"])
def test_k1e_wrapper_rejects(curves, case):
    """The wrapper raises on what K1e does not take; a tensor on a device
    with no kernel is refused, never computed on the CPU."""
    F = curves[1].fq
    a = F.from_ints([1, 2, 3], "cpu")
    b = a.clone()
    op = "mul"
    if case == "shape":
        b = F.from_ints([1, 2], "cpu")
    elif case == "dtype":
        b = b.to(torch.int64)
    elif case == "limbs":
        a, b = a[:4], b[:4]
    elif case == "device":
        a, b = a.to("meta"), b.to("meta")
    else:
        op = "div"
    with pytest.raises((ValueError, TypeError)):
        tfp.fp_op(F, op, a, b)


def _entry_points(dc):
    """Every port function that makes a tensor from host data, called
    without a device."""
    F, F2 = dc.fq, dc.fq2
    limbs = np.zeros((16, 2), dtype=np.uint32)
    return {
        "const": lambda: F.const(5),
        "from_ints": lambda: F.from_ints([1, 2]),
        "plain_from_ints": lambda: F.plain_from_ints([1, 2]),
        "zero": lambda: F.zero((2,)),
        "one": lambda: F.one((2,)),
        "fq2_from_host": lambda: F2.from_host((1, 2)),
        "fq2_from_host_batch": lambda: F2.from_host_batch([(1, 2)]),
        "fq2_one": lambda: F2.one((2,)),
        "proj_zero": lambda: dc.g2.proj_zero((2,)),
        "field_to_torch": lambda: convert.field_to_torch(limbs),
        "affine_to_torch": lambda: convert.affine_to_torch(
            (limbs, limbs, np.zeros(2, dtype=bool))),
        "point_to_torch": lambda: convert.point_to_torch((limbs,) * 3),
    }


@pytest.mark.parametrize("name", sorted(_entry_points(device_curve(
    "alt_bn128"))))
def test_entry_points_default_to_the_card(curves, name):
    """Without a device the entry points put their tensors on the card;
    with no card they raise through torch and make no CPU tensor."""
    make = _entry_points(curves[1])[name]
    if torch.cuda.is_available():
        out = make()
        assert all(t.device.type == "cuda" for t in
                   (out if isinstance(out, tuple) else (out,)))
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()
