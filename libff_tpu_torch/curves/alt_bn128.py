"""alt_bn128 (BN254) curve definition.

Seed constants are the public BN254 parameters (cross-checked in tests
against the literals of libff/algebra/curves/alt_bn128/alt_bn128_init.cpp);
all Montgomery/Frobenius/twist/final-exponent constants are derived.

The curve: y^2 = x^3 + 3 over Fq, |G1| = r, parameter u = 4965661367192848881,
  q = 36u^4 + 36u^3 + 24u^2 + 6u + 1
  r = 36u^4 + 36u^3 + 18u^2 + 6u + 1
Tower: Fq2 = Fq[U]/(U^2 + 1), Fq6 = Fq2[V]/(V^3 - (9+U)),
Fq12 = Fq6[W]/(W^2 - V).  G2 lies on the D-twist y^2 = x^3 + 3/(9+U).
Optimal-ate loop count 6u+2 (alt_bn128_init.cpp:440), final exponent
(q^12-1)/r (:442-455).
"""

from __future__ import annotations

from ..host import ec as hec
from ..host import field as hf
from .curvedef import CurveDef, GroupDef, PairingDef, register

U = 4965661367192848881  # BN parameter (alt_bn128_init.cpp:378 sage excerpt)

Q = 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1
R = 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1

Fr = hf.Fp(R, bits=254, name="alt_bn128_Fr")
Fq = hf.Fp(Q, bits=254, name="alt_bn128_Fq")

# Fq2 = Fq[U]/(U^2 - (-1))   (alt_bn128_init.cpp:138-140: non_residue = q-1)
Fq2 = hf.Ext(Fq, 2, Q - 1, name="alt_bn128_Fq2")
# Fq6 = Fq2[V]/(V^3 - (9+U)) (alt_bn128_init.cpp:154-155)
FQ6_NON_RESIDUE = (9, 1)
Fq6 = hf.Ext(Fq2, 3, FQ6_NON_RESIDUE, name="alt_bn128_Fq6")
# Fq12 = Fq6[W]/(W^2 - V): libff implements Fq12 as 2-over-3-over-2 where the
# quadratic non-residue is V, i.e. sparse (0,1,0) over Fq2.
Fq12 = hf.Ext(Fq6, 2, ((0, 0), (1, 0), (0, 0)), name="alt_bn128_Fq12")

# --- groups ---------------------------------------------------------------

G1_CURVE = hec.WeierstrassCurve(Fq, 0, 3, name="alt_bn128_G1")

TWIST = (9, 1)                       # xi = 9 + U (alt_bn128_init.cpp:267)
TWIST_COEFF_B = Fq2.mul_base(Fq2.inv(TWIST), 3)  # b / xi  (D-type twist)
G2_CURVE = hec.WeierstrassCurve(Fq2, Fq2.zero(), TWIST_COEFF_B,
                                name="alt_bn128_G2")

# generator coordinates (alt_bn128_init.cpp:289-290, 358-369)
G1_ONE = (1, 2)
G2_ONE = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# cofactors: G1 has h = 1 (alt_bn128_init.cpp:297); G2 h derived from u
# (sage excerpt at alt_bn128_init.cpp:376-380)
G2_COFACTOR = 36 * U**4 + 36 * U**3 + 30 * U**2 + 6 * U + 1

g1 = GroupDef(
    name="alt_bn128_G1",
    curve=G1_CURVE,
    generator=G1_ONE,
    cofactor=1,
    order=R,
    wnaf_window_table=(11, 24, 60, 127),           # alt_bn128_init.cpp:300-304
    fixed_base_exp_window_table=(                   # alt_bn128_init.cpp:306-350
        1, 5, 11, 32, 55, 162, 360, 815, 2373, 6978, 7122, 0, 57818, 0,
        169679, 439759, 936073, 0, 4666555, 7580404, 0, 34552892),
)

g2 = GroupDef(
    name="alt_bn128_G2",
    curve=G2_CURVE,
    generator=G2_ONE,
    cofactor=G2_COFACTOR,
    order=R,
    wnaf_window_table=(5, 15, 39, 109),             # alt_bn128_init.cpp:386-390
    fixed_base_exp_window_table=(                   # alt_bn128_init.cpp:392-436
        1, 5, 10, 25, 59, 154, 334, 743, 2034, 4988, 8888, 26271, 39768,
        106276, 141703, 462423, 926872, 0, 4873049, 5706708, 0, 31673815),
)

pairing = PairingDef(
    kind="bn",
    ate_loop_count=6 * U + 2,                       # alt_bn128_init.cpp:440
    ate_is_loop_count_neg=False,
    final_exponent=(Q**12 - 1) // R,
    final_exponent_z=U,
    final_exponent_is_z_neg=False,
    twist=TWIST,
    twist_type="D",
    embedding_degree=12,
)

curve = register(CurveDef(
    name="alt_bn128",
    r=R,
    q=Q,
    fr=Fr,
    fq=Fq,
    fr_nqr=5,                                       # alt_bn128_init.cpp:76
    fr_multiplicative_generator=5,                  # alt_bn128_init.cpp:72
    fq_nqr=3,                                       # alt_bn128_init.cpp:118
    fq_multiplicative_generator=3,                  # alt_bn128_init.cpp:114
    fq2=Fq2,
    fq3=None,
    fq6=Fq6,
    fq12=Fq12,
    gt=Fq12,
    g1=g1,
    g2=g2,
    pairing=pairing,
))
