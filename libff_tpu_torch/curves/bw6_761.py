"""BW6-761 curve definition — one-layer proof composition over BLS12-377
(eprint 2020/351): bw6_761.r equals bls12_377.q, so BLS12-377 proofs can be
verified inside a BW6-761 circuit.

Seed constants are the public parameters (cross-checked in tests against
the literals of libff/algebra/curves/bw6_761/bw6_761_init.cpp).

E(Fq): y^2 = x^3 - 1 over the 761-bit Fq.  G2 lies on the M-twist
y^2 = x^3 + 4 over Fq ITSELF (no extension: the twist is by the sextic
non-residue -4; bw6_761_init.cpp:264-281).  Tower: Fq3 = Fq[U]/(U^3+4),
Fq6 = Fq3[W]/(W^2-U); GT = Fq6.  The ate pairing runs TWO NAF-driven
Miller loops (loop counts u+1 and u^3-u^2-u, u the BLS12-377 parameter)
combined as f1 * Frobenius(f2) (bw6_761_pairing.cpp:369-505), with the
Algorithm-6 (2020/351) final-exponentiation hard part.
"""

from __future__ import annotations

from ..host import ec as hec
from ..host import field as hf
from .curvedef import CurveDef, GroupDef, PairingDef, register

U = 0x8508C00000000001                 # the BLS12-377 parameter u

# r = bls12_377.q ; q = 761-bit modulus (bw6_761_init.cpp:38, 84)
R = ((U - 1) ** 2 * (U**4 - U**2 + 1)) // 3 + U
Q = int(
    "689145038431573253939678968227565754247966891253615010951379016020962342"
    "224349173608768318328941168764086456775378661345116175912055424775934951"
    "169912530159895160509937850885037254363142359679595189970042996911284276"
    "4913119068299")

Fr = hf.Fp(R, bits=377, name="bw6_761_Fr")
Fq = hf.Fp(Q, bits=761, name="bw6_761_Fq")

# Fq3 = Fq[U]/(U^3 - (-4))  (bw6_761_init.cpp:192)
FQ3_NON_RESIDUE = Q - 4
Fq3 = hf.Ext(Fq, 3, FQ3_NON_RESIDUE, name="bw6_761_Fq3")
# Fq6 = Fq3[W]/(W^2 - U)  (2-over-3)
Fq6 = hf.Ext(Fq3, 2, (0, 1, 0), name="bw6_761_Fq6")

# --- groups ---------------------------------------------------------------

COEFF_B = Q - 1                        # -1
G1_CURVE = hec.WeierstrassCurve(Fq, 0, COEFF_B, name="bw6_761_G1")

TWIST = Q - 4                          # -4, in Fq (sextic twist in Fq)
TWIST_COEFF_B = 4                      # b * twist = (-1)(-4)
G2_CURVE = hec.WeierstrassCurve(Fq, 0, TWIST_COEFF_B, name="bw6_761_G2")

# generators (bw6_761_init.cpp:287-296, 368-377)
G1_ONE = (
    6238772257594679368032145693622812838779005809760824733138787810501188623461307351759238099287535516224314149266511977132140828635950940021790489507611754366317801811090811367945064510304504157188661901055903167026722666149426237,
    2101735126520897423911504562215834951148127555913367997162789335052900271653517958562461315794228241561913734371411178226936527683203879553093934185950470971848972085321797958124416462268292467002957525517188485984766314758624099,
)
G2_ONE = (
    6445332910596979336035888152774071626898886139774101364933948236926875073754470830732273879639675437155036544153105017729592600560631678554299562762294743927912429096636156401171909259073181112518725201388196280039960074422214428,
    562923658089539719386922163444547387757586534741080263946953401595155211934630598999300396317104182598044793758153214972605680357108252243146746187917218885078195819486220416605630144001533548163105316661692978285266378674355041,
)

G1_COFACTOR = int(
    "2664243587933581668398767770148807386775111827005265065594210250231297"
    "7592501693353047140953112195348280268661194876")
G2_COFACTOR = int(
    "2664243587933581668398767770148807386775111827005265065594210250231297"
    "7592501693353047140953112195348280268661194869")

g1 = GroupDef(
    name="bw6_761_G1",
    curve=G1_CURVE,
    generator=G1_ONE,
    cofactor=G1_COFACTOR,
    order=R,
    wnaf_window_table=(11, 24, 60, 127),   # same table as alt_bn128 (TODO
    fixed_base_exp_window_table=(           # upstream, bw6_761_init.cpp:308)
        1, 5, 11, 32, 55, 162, 360, 815, 2373, 6978, 7122, 0, 57818, 0,
        169679, 439759, 936073, 0, 4666555, 7580404, 0, 34552892),
)

g2 = GroupDef(
    name="bw6_761_G2",
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
    kind="bw6",
    ate_loop_count=U + 1,                   # loop 1 (bw6_761_init.cpp:447)
    ate_is_loop_count_neg=False,
    final_exponent=(Q**6 - 1) // R,
    final_exponent_z=U,                     # bw6_761_init.cpp:453
    final_exponent_is_z_neg=False,
    twist=TWIST,
    twist_type="M",
    embedding_degree=6,
    extra={
        "ate_loop_count1": U + 1,
        "ate_loop_count2": U**3 - U**2 - U,  # bw6_761_init.cpp:449-450
    },
)

curve = register(CurveDef(
    name="bw6_761",
    r=R,
    q=Q,
    fr_nqr=5,                               # bw6_761_init.cpp:75
    fr_multiplicative_generator=15,         # bw6_761_init.cpp:71
    fq_nqr=2,                               # bw6_761_init.cpp:140
    fq_multiplicative_generator=2,          # bw6_761_init.cpp:134
    fr=Fr,
    fq=Fq,
    fq2=None,
    fq3=Fq3,
    fq6=Fq6,
    fq12=None,
    gt=Fq6,
    g1=g1,
    g2=g2,
    pairing=pairing,
))
