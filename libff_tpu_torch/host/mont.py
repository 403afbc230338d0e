"""Host-side Montgomery parameter derivation and limb packing.

The reference (clearmatics/libff) bakes Montgomery constants into per-curve
init files as decimal strings (e.g. libff/algebra/curves/alt_bn128/
alt_bn128_init.cpp:43-122) after deriving them offline with SageMath
(libff/algebra/curves/params_generator.sage).  Here we derive everything at
import time from the modulus alone, with pure Python integers, and
cross-check against the reference's literals in tests.

libff uses 64-bit GMP limbs with ``num_limbs = ceil(bits/64)`` and
``R = 2**(64*num_limbs)``.  The TPU kernels use radix-2^16 limbs held in
uint32 lanes (no 64x64->128 multiply on TPU), with ``num_limbs16 =
4*num_limbs64`` so that R — and therefore the Montgomery representation and
all serialized bytes — matches libff bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import functools

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def num_limbs64(bits: int) -> int:
    return (bits + 63) // 64


@dataclasses.dataclass(frozen=True)
class MontParams:
    """All per-modulus constants, derived from the modulus.

    Mirrors the static members of libff's Fp_model (libff/algebra/fields/
    fp.hpp:60-82): num_bits, euler, s, t, t_minus_1_over_2, inv, Rsquared,
    Rcubed — plus the radix-2^16 equivalents used on device.
    """

    p: int
    bits: int
    n64: int      # number of 64-bit limbs (libff convention)
    n16: int      # number of 16-bit limbs used on device (= 4 * n64)
    R: int        # 2^(64*n64) mod p
    R2: int       # R^2 mod p
    R3: int       # R^3 mod p
    inv64: int    # -p^-1 mod 2^64  (libff `inv`)
    inv16: int    # -p^-1 mod 2^16  (device CIOS constant)
    euler: int    # (p-1)/2
    s: int        # p-1 = t * 2^s, t odd
    t: int
    t_minus_1_over_2: int


@functools.lru_cache(maxsize=None)
def derive(p: int, bits: int | None = None) -> MontParams:
    if bits is None:
        bits = p.bit_length()
    n64 = num_limbs64(bits)
    n16 = 4 * n64
    Rexp = 64 * n64
    R = pow(2, Rexp, p)
    inv64 = (-pow(p, -1, 1 << 64)) % (1 << 64)
    t = p - 1
    s = 0
    while t % 2 == 0:
        t //= 2
        s += 1
    return MontParams(
        p=p,
        bits=bits,
        n64=n64,
        n16=n16,
        R=R,
        R2=(R * R) % p,
        R3=(R * R * R) % p,
        inv64=inv64,
        inv16=inv64 & 0xFFFF,
        euler=(p - 1) // 2,
        s=s,
        t=t,
        t_minus_1_over_2=(t - 1) // 2,
    )


def to_mont(mp: MontParams, v: int) -> int:
    """Plain integer -> Montgomery representative (as an integer)."""
    return (v % mp.p) * mp.R % mp.p


def from_mont(mp: MontParams, v: int) -> int:
    """Montgomery representative -> plain integer."""
    return v * pow(mp.R, -1, mp.p) % mp.p


# ---------------------------------------------------------------------------
# Limb packing (int <-> list of radix-2^16 limbs, little-endian)
# ---------------------------------------------------------------------------

def int_to_limbs(v: int, n16: int) -> list[int]:
    assert 0 <= v < (1 << (LIMB_BITS * n16)), "value does not fit in limbs"
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n16)]


def limbs_to_int(limbs) -> int:
    v = 0
    for i, l in enumerate(limbs):
        v |= int(l) << (LIMB_BITS * i)
    return v


def int_to_bytes_be(v: int, n64: int) -> bytes:
    """libff binary field encoding: the n64*8-byte big-endian integer
    (field_serialization.tcc:197-208 writes the limb array byte-reversed,
    which for a little-endian machine is exactly big-endian bytes)."""
    return v.to_bytes(8 * n64, "big")


def bytes_be_to_int(b: bytes) -> int:
    return int.from_bytes(b, "big")
