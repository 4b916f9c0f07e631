"""STO-3G basis data.

STO-3G is defined (Hehre, Stewart & Pople, J. Chem. Phys. 51, 2657 (1969))
as fixed three-Gaussian fits of Slater orbitals with zeta = 1, scaled per
element/shell by zeta**2 on the exponents. The distributed tables (EMSL/BSE,
also shipped by PySCF) are those rule values *rounded to 8 significant
digits*; energies are sensitive enough to core exponents (~1e-6 Ha for a
1e-8 relative change) that we store the standard rounded literals for the
common elements to match reference energies exactly, and fall back to the
generating rule elsewhere.
"""

# zeta=1 three-Gaussian fits (exponent, coefficient) per Slater shell type.
_FIT_1S = [(2.227660584, 0.154328967), (0.405771156, 0.535328142), (0.109818, 0.444634542)]
_FIT_2S = [(0.994203, -0.0999672), (0.231031, 0.399513), (0.0751386, 0.700115)]
_FIT_2P = [(0.994203, 0.155916), (0.231031, 0.607684), (0.0751386, 0.391957)]

# Standard molecular scaling factors zeta = (zeta_1s, zeta_2sp) per element.
_ZETA = {
    "H": (1.24,),
    "He": (1.69,),
    "Li": (2.69, 0.80),
    "Be": (3.68, 1.15),
    "B": (4.68, 1.45),
    "C": (5.67, 1.72),
    "N": (6.67, 1.95),
    "O": (7.66, 2.25),
    "F": (8.65, 2.55),
    "Ne": (9.64, 2.88),
}

_S_COEF = (0.15432897, 0.53532814, 0.44463454)
_SP_S_COEF = (-0.09996723, 0.39951283, 0.70011547)
_SP_P_COEF = (0.15591627, 0.60768372, 0.39195739)

# Published (rounded) exponent tables: {element: (exps_1s, exps_2sp)}
_PUBLISHED_EXPS = {
    "H": ((3.42525091, 0.62391373, 0.16885540), None),
    "He": ((6.36242139, 1.15892300, 0.31364979), None),
    "C": ((71.61683700, 13.04509600, 3.53051220),
          (2.94124940, 0.68348310, 0.22228990)),
    "N": ((99.10616900, 18.05231200, 4.88566020),
          (3.78045590, 0.87849660, 0.28571440)),
    "O": ((130.70932000, 23.80886100, 6.44360830),
          (5.03315130, 1.16959610, 0.38038900)),
    "F": ((166.67913000, 30.36081200, 8.21682070),
          (6.46480320, 1.50228120, 0.48858850)),
}


def _scale(fit, zeta):
    z2 = zeta * zeta
    return [(a * z2, c) for a, c in fit]


# ---------------------------------------------------------------- second row
# Na-Ar tables verified against the STO-3G generating rule by
# scripts/gen_sto3g_row2.py: every exponent below either matches the
# recovered universal fit x zeta**2 factorisation to ~1e-10 relative
# ("verbatim" -- the distributed EMSL/BSE value) or is regenerated from the
# rule after an entry pinned the element's zeta to the published 2-decimal
# grid at ~1e-11 (Al/Si 2sp entries 2-3, P 1s entry 3).  Na and Mg are
# deliberately absent: their 3sp rows could not be verified, and shipping
# unverified basis data is worse than none (use a BSE JSON file for them).
# Deriving their zetas variationally is NOT an option either:
# scripts/opt_sto3g_row3_zeta.py demonstrates that unconstrained atomic
# optimization collapses the valence zeta into the core (the published
# valence scale factors are molecular calibrations, unlike Dunning's
# atomic-HF-optimal cc-pVDZ rule).
# zeta (1s, 2sp, 3sp): Al (12.56, 4.36, 1.70)  Si (13.53, 4.83, 1.75)
#                      P  (14.50, 5.31, 1.90)  S  (15.47, 5.79, 2.05)
#                      Cl (16.43, 6.26, 2.10)  Ar (17.40, 6.74, 2.33)
_SP3_S_COEF = (-0.2196203690, 0.2255954336, 0.9003984260)
_SP3_P_COEF = (0.01058760429, 0.5951670053, 0.4620010120)

_PUBLISHED_ROW2 = {
    "Al": ((351.4214767, 64.01186067, 17.32410761),
           (18.89939621, 4.39181323, 1.42835397),
           (1.395448293, 0.3893265318, 0.1523797659)),
    "Si": ((407.7975514, 74.28083305, 20.10329229),
           (23.19365606, 5.38970687, 1.75289995),
           (1.478740622, 0.4125648801, 0.1614750979)),
    "P": ((468.3656378, 85.31338559, 23.08913160),
          (28.03263958, 6.514182577, 2.118614352),
          (1.743103231, 0.4863213771, 0.1903428909)),
    "S": ((533.1257359, 97.10951830, 26.28162542),
          (33.32975173, 7.745117521, 2.518952599),
          (2.029194274, 0.5661400518, 0.2215833792)),
    "Cl": ((601.3456136, 109.5358542, 29.64467686),
           (38.96041889, 9.053563477, 2.944499834),
           (2.129386495, 0.5940934274, 0.2325241410)),
    "Ar": ((674.4465184, 122.8512753, 33.24834945),
           (45.16424392, 10.49519900, 3.413364448),
           (2.621366518, 0.7313546050, 0.2862472356)),
}


def _element(sym):
    row2 = _PUBLISHED_ROW2.get(sym)
    if row2 is not None:
        exps_1s, exps_2sp, exps_3sp = row2
        return [
            (0, list(zip(exps_1s, _S_COEF))),
            (0, list(zip(exps_2sp, _SP_S_COEF))),
            (1, list(zip(exps_2sp, _SP_P_COEF))),
            (0, list(zip(exps_3sp, _SP3_S_COEF))),
            (1, list(zip(exps_3sp, _SP3_P_COEF))),
        ]
    published = _PUBLISHED_EXPS.get(sym)
    zetas = _ZETA[sym]
    if published is not None:
        exps_1s, exps_2sp = published
        shells = [(0, list(zip(exps_1s, _S_COEF)))]
        if exps_2sp is not None:
            shells.append((0, list(zip(exps_2sp, _SP_S_COEF))))
            shells.append((1, list(zip(exps_2sp, _SP_P_COEF))))
        return shells
    shells = [(0, _scale(_FIT_1S, zetas[0]))]
    if len(zetas) > 1:
        shells.append((0, _scale(_FIT_2S, zetas[1])))
        shells.append((1, _scale(_FIT_2P, zetas[1])))
    return shells


STO3G = {sym: _element(sym) for sym in list(_ZETA) + list(_PUBLISHED_ROW2)}
