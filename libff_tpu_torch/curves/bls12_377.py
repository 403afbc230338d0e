"""BLS12-377 curve definition (the Zexe curve).

Seed constants are the public BLS12-377 parameters (cross-checked in tests
against the literals of libff/algebra/curves/bls12_377/bls12_377_init.cpp);
Montgomery/Frobenius/twist/final-exponent constants are derived.

Family parameter z = 0x8508c00000000001:
  r = z^4 - z^2 + 1                    (253 bits)
  q = ((z-1)^2 * r) / 3 + z            (377 bits)
E(Fq): y^2 = x^3 + 1.  Tower: Fq2 = Fq[U]/(U^2+5), Fq6 = Fq2[V]/(V^3-U),
Fq12 = Fq6[W]/(W^2-V).  G2 lies on the D-type twist y^2 = x^3 + 1/U
(bls12_377_init.cpp:300-304).  Optimal-ate loop count z, positive
(bls12_377_init.cpp:538-539).

Extras carried in PairingDef.extra / GroupDef use:
  * G1 sigma endomorphism (x,y) -> (beta*x, y) with beta a primitive cube
    root of unity, and the fast subgroup check [c1]sigma(P) + P == 0
    (bls12_377_g1.cpp:359-397, constants bls12_377_init.cpp:365-371).
  * G2 untwist-Frobenius-twist endomorphism for fast cofactor
    multiplication (bls12_377_g2.cpp:378-432).
"""

from __future__ import annotations

from ..host import ec as hec
from ..host import field as hf
from .curvedef import CurveDef, GroupDef, PairingDef, register

Z = 0x8508C00000000001                      # bls12_377_init.cpp:538

R = Z**4 - Z**2 + 1
Q = ((Z - 1) ** 2 * R) // 3 + Z

Fr = hf.Fp(R, bits=253, name="bls12_377_Fr")
Fq = hf.Fp(Q, bits=377, name="bls12_377_Fq")

# Fq2 = Fq[U]/(U^2 - (-5))  (bls12_377_init.cpp:174-176)
Fq2 = hf.Ext(Fq, 2, Q - 5, name="bls12_377_Fq2")
# Fq6 = Fq2[V]/(V^3 - U)
FQ6_NON_RESIDUE = (0, 1)
Fq6 = hf.Ext(Fq2, 3, FQ6_NON_RESIDUE, name="bls12_377_Fq6")
# Fq12 = Fq6[W]/(W^2 - V)
Fq12 = hf.Ext(Fq6, 2, ((0, 0), (1, 0), (0, 0)), name="bls12_377_Fq12")

# --- groups ---------------------------------------------------------------

G1_CURVE = hec.WeierstrassCurve(Fq, 0, 1, name="bls12_377_G1")

TWIST = (0, 1)                               # xi = U
# D-type twist: b' = b / xi (bls12_377_init.cpp:304)
TWIST_COEFF_B = Fq2.inv(TWIST)
G2_CURVE = hec.WeierstrassCurve(Fq2, Fq2.zero(), TWIST_COEFF_B,
                                name="bls12_377_G2")

# generators (bls12_377_init.cpp:311-319, 400-417)
G1_ONE = (
    81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
)
G2_ONE = (
    (111583945774695116443911226257823823434468740249883042837745151039122196680777376765707574547389190084887628324746,
     129066980656703085518157301154335215886082112524378686555873161080604845924984124025594590925548060469686767592854),
    (168863299724668977183029941347596462608978380503965103341003918678547611204475537878680436662916294540335494194722,
     233892497287475762251335351893618429603672921469864392767514552093535653615809913098097380147379993375817193725968),
)

# cofactors: G1 h = (z-1)^2 / 3 (cross-checked vs bls12_377_init.cpp:341-342);
# G2 h is the standard literal (bls12_377_init.cpp:452-455)
G1_COFACTOR = (Z - 1) ** 2 // 3
G2_COFACTOR = int(
    "792321491528431714393029355064387456688101785017794542476925675916530143661"
    "693322820927796677409248646728947861840476141263069183576467455937640765849"
    "7")

# G1 sigma endomorphism + fast subgroup check (bls12_377_init.cpp:364-371):
# beta is a primitive cube root of unity in Fq; c1 = z^2 - 1 here so that
# [c1]sigma(P) + P == 0 iff P is in the order-r subgroup.
G1_ENDO_BETA = int(
    "809496482649127194085583631406374772648452947207104994781372872627125359383"
    "01461879813459410945")
G1_SAFE_SUBGROUP_C1 = 91893752504881257701523279626832445441
# proof-of-subgroup helper constants (bls12_377_init.cpp:373-382)
G1_PROOF_OF_SUBGROUP_W = 5285428838741532253824584287042945485047145357130994810877
G1_PROOF_OF_SUBGROUP_NON_MEMBER_X = int(
    "557913522467838724047884679099070925093640102299038802036896964987876157349"
    "38123558571181995209025075818229621722")
G1_PROOF_OF_SUBGROUP_NON_MEMBER_Y = int(
    "174363855833520138229666723484835348689236585013460554444609730120603741818"
    "916846216286948728983932214174344518655")

g1 = GroupDef(
    name="bls12_377_G1",
    curve=G1_CURVE,
    generator=G1_ONE,
    cofactor=G1_COFACTOR,
    order=R,
    wnaf_window_table=(11, 24, 60, 127),
    fixed_base_exp_window_table=(            # bls12_377_init.cpp:345-398
        1, 5, 11, 32, 55, 162, 360, 815, 2373, 6978, 7122, 0, 57818, 0,
        169679, 439759, 936073, 0, 4666555, 7580404, 0, 34552892),
    extra={
        # sigma endomorphism (x,y) -> (beta*x, y) and the fast subgroup
        # check [c1] sigma(P) + P == 0 (bls12_377_g1.cpp:359-397)
        "endo_beta": G1_ENDO_BETA,
        "safe_subgroup_c1": G1_SAFE_SUBGROUP_C1,
        "proof_of_subgroup_w": G1_PROOF_OF_SUBGROUP_W,
        "proof_of_subgroup_non_member_x": G1_PROOF_OF_SUBGROUP_NON_MEMBER_X,
        "proof_of_subgroup_non_member_y": G1_PROOF_OF_SUBGROUP_NON_MEMBER_Y,
    },
)

# G2 untwist-Frobenius-twist endomorphism psi (bls12_377_g2.cpp:378-421):
# on the D-type twist, psi(x, y) = (xi^((q-1)/3) * x^q, xi^((q-1)/2) * y^q)
# — the same map as the tower round-trip through Fq12, derived here directly.
G2_PSI_X = Fq2.pow(TWIST, (Q - 1) // 3)
G2_PSI_Y = Fq2.pow(TWIST, (Q - 1) // 2)
# trace of Frobenius t = z + 1 (pinned literal bls12_377_init.cpp:338)
TRACE_OF_FROBENIUS = Z + 1
# fast cofactor multiplication [h2]P = [h2_0]P + [h2_1]([t]psi(P) - psi^2(P))
# (bls12_377_g2.cpp:423-432; constants bls12_377_init.cpp:470-474; h2_1
# equals the G1 cofactor (z-1)^2/3)
G2_COFACTOR_H2_0 = int(
    "293634935485640680722085584138834120318524213360527933441")
G2_COFACTOR_H2_1 = G1_COFACTOR

g2 = GroupDef(
    name="bls12_377_G2",
    curve=G2_CURVE,
    generator=G2_ONE,
    cofactor=G2_COFACTOR,
    order=R,
    wnaf_window_table=(5, 15, 39, 109),
    fixed_base_exp_window_table=(
        1, 5, 10, 25, 59, 154, 334, 743, 2034, 4988, 8888, 26271, 39768,
        106276, 141703, 462423, 926872, 0, 4873049, 5706708, 0, 31673815),
    extra={
        "psi_x": G2_PSI_X,
        "psi_y": G2_PSI_Y,
        "trace_of_frobenius": TRACE_OF_FROBENIUS,
        "cofactor_h2_0": G2_COFACTOR_H2_0,
        "cofactor_h2_1": G2_COFACTOR_H2_1,
    },
)

pairing = PairingDef(
    kind="bls12",
    ate_loop_count=Z,                        # bls12_377_init.cpp:538-539
    ate_is_loop_count_neg=False,
    final_exponent=(Q**12 - 1) // R,
    final_exponent_z=Z,
    final_exponent_is_z_neg=False,
    twist=TWIST,
    twist_type="D",
    embedding_degree=12,
    extra={
        "g1_endo_beta": G1_ENDO_BETA,
        "g1_safe_subgroup_c1": G1_SAFE_SUBGROUP_C1,
        "g1_proof_of_subgroup_w": G1_PROOF_OF_SUBGROUP_W,
        "g1_proof_of_subgroup_non_member_x": G1_PROOF_OF_SUBGROUP_NON_MEMBER_X,
        "g1_proof_of_subgroup_non_member_y": G1_PROOF_OF_SUBGROUP_NON_MEMBER_Y,
    },
)

curve = register(CurveDef(
    name="bls12_377",
    r=R,
    q=Q,
    fr_nqr=11,                               # bls12_377_init.cpp:95
    fr_multiplicative_generator=22,          # bls12_377_init.cpp:91
    fq_nqr=5,                                # bls12_377_init.cpp:147
    fq_multiplicative_generator=15,          # bls12_377_init.cpp:141
    fr=Fr,
    fq=Fq,
    fq2=Fq2,
    fq3=None,
    fq6=Fq6,
    fq12=Fq12,
    gt=Fq12,
    g1=g1,
    g2=g2,
    pairing=pairing,
))
