"""BLS12-381 curve constants.

Mirrors the parameter surface of the reference's `crypto/bls` (see
crypto/bls/src/lib.rs) but holds the raw curve math constants
that the reference delegates to the vendored blst library.

All derived constants (Frobenius coefficients, psi-endomorphism coefficients,
Montgomery parameters for the device limb representation) are *computed* here at
import time from the primary parameters, never hard-coded, so a single wrong
digit is caught by the self-checks in tests/test_torch_fields.py.
"""

# --- Primary parameters -----------------------------------------------------

# Base field prime.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order (scalar field).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative).
X = -0xD201000000010000

# Curve equations: E1/Fp: y^2 = x^3 + 4 ; E2/Fp2: y^2 = x^3 + 4(1+u).
B1 = 4
B2 = (4, 4)  # 4*(1+u) as (c0, c1)

# Cofactors.
H1 = 0x396C8C005555E1568C00AAAB0000AAAB  # (x-1)^2 / 3
# G2 cofactor: (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13) / 9
# (x is the signed curve parameter).
H2 = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9

# Generators (standard, from the IETF pairing-friendly-curves draft).
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# Domain separation tag used by Ethereum consensus BLS signatures
# (reference: crypto/bls/src/impls/blst.rs:14).
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# Random scalar width for batch verification
# (reference: crypto/bls/src/impls/blst.rs:15).
RAND_BITS = 64

# --- Sanity identities (cheap; run at import) -------------------------------

assert R == X**4 - X**2 + 1
assert P == (X - 1) ** 2 * (X**4 - X**2 + 1) // 3 + X
assert P % 4 == 3  # sqrt via a^((p+1)/4)
assert H1 == (X - 1) ** 2 // 3
assert H2 * 9 == X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13

# --- RFC 9380 §8.8.2 / Appendix E.3: 3-isogeny for BLS12381G2 SSWU ----------
# Isogenous curve E2': y'^2 = x'^3 + A' x' + B', with:
ISO3_A = (0, 240)  # 240 * u
ISO3_B = (1012, 1012)  # 1012 * (1 + u)
ISO3_Z = (-2 % P, -1 % P)  # Z = -(2 + u)

# Rational map coefficients (Fp2 as (c0, c1) pairs).  These large literals are
# verified structurally in tests: the composed SSWU+isogeny map must land on
# E2 for random inputs, which fails for any perturbed coefficient.
_K = 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6
ISO3_XNUM = [
    (_K, _K),
    (0, 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    (0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1, 0),
]
ISO3_XDEN = [
    (0, P - 0x48),  # p - 72
    (0xC, P - 0xC),
    (1, 0),  # leading coefficient of x'^2
]
ISO3_YNUM = [
    (
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    (0, 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    (0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10, 0),
]
ISO3_YDEN = [
    (P - 0x1B0, P - 0x1B0),  # (p - 432) * (1 + u)
    (0, P - 0xD8),  # (p - 216) * u
    (0x12, P - 0x12),
    (1, 0),  # leading coefficient of x'^3
]
