"""BLS12-381 curve definition.

Seed constants are the public BLS12-381 parameters (cross-checked in tests
against the literals of libff/algebra/curves/bls12_381/bls12_381_init.cpp);
all Montgomery/Frobenius/twist/final-exponent constants are derived.

The curve family parameter is z = -0xd201000000010000:
  r = z^4 - z^2 + 1                    (255 bits)
  q = ((z-1)^2 * r) / 3 + z            (381 bits)
E(Fq): y^2 = x^3 + 4.  Tower: Fq2 = Fq[U]/(U^2+1), Fq6 = Fq2[V]/(V^3-(1+U)),
Fq12 = Fq6[W]/(W^2-V).  G2 lies on the M-type twist y^2 = x^3 + 4*(1+U)
(bls12_381_init.cpp:419-420).  Optimal-ate loop count |z|, negative
(bls12_381_init.cpp:600-602).
"""

from __future__ import annotations

from ..host import ec as hec
from ..host import field as hf
from .curvedef import CurveDef, GroupDef, PairingDef, register

Z = -0xD201000000010000                   # bls12_381_init.cpp:623 (|z|, neg)

R = Z**4 - Z**2 + 1
Q = ((Z - 1) ** 2 * R) // 3 + Z

Fr = hf.Fp(R, bits=255, name="bls12_381_Fr")
Fq = hf.Fp(Q, bits=381, name="bls12_381_Fq")

# Fq2 = Fq[U]/(U^2 - (-1))  (bls12_381_init.cpp:137-139)
Fq2 = hf.Ext(Fq, 2, Q - 1, name="bls12_381_Fq2")
# Fq6 = Fq2[V]/(V^3 - (1+U)) (bls12_381_init.cpp:197-198)
FQ6_NON_RESIDUE = (1, 1)
Fq6 = hf.Ext(Fq2, 3, FQ6_NON_RESIDUE, name="bls12_381_Fq6")
# Fq12 = Fq6[W]/(W^2 - V)
Fq12 = hf.Ext(Fq6, 2, ((0, 0), (1, 0), (0, 0)), name="bls12_381_Fq12")

# --- groups ---------------------------------------------------------------

G1_CURVE = hec.WeierstrassCurve(Fq, 0, 4, name="bls12_381_G1")

TWIST = (1, 1)                            # xi = 1 + U
# M-type twist: b' = b * xi (bls12_381_init.cpp:420)
TWIST_COEFF_B = Fq2.mul_base(TWIST, 4)
G2_CURVE = hec.WeierstrassCurve(Fq2, Fq2.zero(), TWIST_COEFF_B,
                                name="bls12_381_G2")

# standard generators (bls12_381_init.cpp:441-449, 517-533)
G1_ONE = (
    3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
)
G2_ONE = (
    (352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
     3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758),
    (1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
     927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582),
)

# cofactors: G1 h = (z-1)^2 / 3; G2 h is the standard literal
# (bls12_381_init.cpp:456-457, 539-542; the G1 formula is cross-checked
# against the literal in tests)
G1_COFACTOR = (Z - 1) ** 2 // 3
G2_COFACTOR = int(
    "305502333931268344200999753193121504214466019254188142667664032982267604182"
    "971884026507427359259977847832272839041616661285803823378372096355777062779"
    "109")

g1 = GroupDef(
    name="bls12_381_G1",
    curve=G1_CURVE,
    generator=G1_ONE,
    cofactor=G1_COFACTOR,
    order=R,
    wnaf_window_table=(11, 24, 60, 127),     # bls12_381_init.cpp:461-466
    fixed_base_exp_window_table=(             # bls12_381_init.cpp:469-512
        1, 5, 11, 32, 55, 162, 360, 815, 2373, 6978, 7122, 0, 57818, 0,
        169679, 439759, 936073, 0, 4666555, 7580404, 0, 34552892),
)

g2 = GroupDef(
    name="bls12_381_G2",
    curve=G2_CURVE,
    generator=G2_ONE,
    cofactor=G2_COFACTOR,
    order=R,
    wnaf_window_table=(5, 15, 39, 109),
    fixed_base_exp_window_table=(
        1, 5, 10, 25, 59, 154, 334, 743, 2034, 4988, 8888, 26271, 39768,
        106276, 141703, 462423, 926872, 0, 4873049, 5706708, 0, 31673815),
)

pairing = PairingDef(
    kind="bls12",
    ate_loop_count=-Z,                        # bls12_381_init.cpp:600-602
    ate_is_loop_count_neg=True,
    final_exponent=(Q**12 - 1) // R,
    final_exponent_z=-Z,                      # |z| with is_z_neg=True (:623)
    final_exponent_is_z_neg=True,
    twist=TWIST,
    twist_type="M",
    embedding_degree=12,
)

curve = register(CurveDef(
    name="bls12_381",
    r=R,
    q=Q,
    fr=Fr,
    fq=Fq,
    fr_nqr=5,                                 # bls12_381_init.cpp:69
    fr_multiplicative_generator=7,            # bls12_381_init.cpp:65
    fq_nqr=2,                                 # bls12_381_init.cpp:114
    fq_multiplicative_generator=2,            # bls12_381_init.cpp:110
    fq2=Fq2,
    fq3=None,
    fq6=Fq6,
    fq12=Fq12,
    gt=Fq12,
    g1=g1,
    g2=g2,
    pairing=pairing,
))
