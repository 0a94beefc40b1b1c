"""Writes ``bls12_381_consts.cuh``: every constant the CUDA kernels use,
computed from ``crypto/bls/constants.py`` (nothing typed by hand).

    python -m lighthouse_tpu_torch.csrc.gen_consts

The header is committed; ``tests/test_torch_fields.py`` checks that it
matches this generator.
"""
from __future__ import annotations

import os

from ..crypto.bls.constants import (
    B2, DST, G1_X, G1_Y, ISO3_A, ISO3_B, ISO3_XDEN, ISO3_XNUM, ISO3_YDEN,
    ISO3_YNUM, ISO3_Z, P, R, X,
)
from ..crypto.bls.fields_ref import Fp2
from ..crypto.bls.cuda import curve, fp, hash_to_g2, pairing, tower

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "bls12_381_consts.cuh")


_C2 = (P * P - 1) // 8
_C3 = (P * P - 9) // 16


def _z_pow(e: int):
    z = Fp2(*ISO3_Z).pow(e)
    return (z.c0, z.c1)


def _windows(e: int, w: int) -> list:
    """Left-to-right sliding windows of e: (squarings, odd-power index)
    pairs, the first with 0 squarings, a last (squarings, 255) for the
    trailing zeros."""
    bits, i, out, pend = bin(e)[2:], 0, [], 0
    while i < len(bits):
        if bits[i] == "0":
            pend += 1
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        v = int(bits[i:j], 2)
        out.append((pend + (j - i) if out else 0, (v - 1) // 2))
        pend, i = 0, j
    if pend:
        out.append((pend, 255))
    return out


def _mont(v: int) -> int:
    return v % P * fp.R_MOD_P % P


def _limbs(v: int) -> str:
    return "{" + ", ".join("0x%08xu" % x for x in fp.int_to_limbs(v)) + "}"


def _fp(name: str, v: int, mont: bool = True) -> str:
    return f"LH_CONST fp_t {name} = {{{_limbs(_mont(v) if mont else v)}}};"


def _fp2_body(pair) -> str:
    return "{{%s}, {%s}}" % (_limbs(_mont(pair[0])), _limbs(_mont(pair[1])))


def _fp2(name: str, pair) -> str:
    return f"LH_CONST fp2_t {name} = {_fp2_body(pair)};"


def _words(name: str, vals) -> str:
    body = ", ".join("0x%08xu" % v for v in vals)
    return f"LH_CONST uint32_t {name}[{len(vals)}] = {{{body}}};"


def render() -> str:
    out = [
        "// Generated by gen_consts.py from crypto/bls/constants.py;",
        "// do not edit.  Montgomery form (R = 2^384) unless noted.",
        "#pragma once",
        "",
        "// Field modulus (plain) and -p^-1 mod 2^32.",
        _fp("LH_P", P, mont=False),
        "#define LH_N0 0x%08xu" % ((-pow(P, -1, 1 << 32)) % (1 << 32)),
        _fp("LH_ONE", 1),
        _fp("LH_R2", fp.R2_MOD_P, mont=False),
        _fp("LH_R3", fp.R_MOD_P * fp.R2_MOD_P % P, mont=False),
        _fp("LH_INV2", pow(2, P - 2, P)),
        "// Exponents (plain): p - 2 (inversion), (p - 3) / 4 (square roots).",
        _fp("LH_EXP_INV", P - 2, mont=False),
        _fp("LH_EXP_SQRT", (P - 3) // 4, mont=False),
        "",
        "// -g1 = (G1_X, -G1_Y), the pair of the signature sum.",
        _fp("LH_G1_X", G1_X),
        _fp("LH_G1_NEG_Y", -G1_Y),
        "",
        "// |x| for the curve parameter x = -|x|, and e1 = (x - 1)^2 / 3.",
        "#define LH_ABS_X 0x%016xull" % (-X),
        _words("LH_E1", [(pairing.E1 >> (32 * i)) & 0xFFFFFFFF
                         for i in range(4)]),
        "",
        "// Simplified SWU on the isogenous curve E2' and the 3-isogeny.",
        _fp2("LH_SSWU_A", ISO3_A),
        _fp2("LH_SSWU_B", ISO3_B),
        _fp2("LH_SSWU_Z", ISO3_Z),
        "// sqrt_ratio (RFC 9380 F.2.1.1, q = p^2, c1 = 3, c2 = (q - 1) / 8):",
        "// c6 = Z^c2, c7 = Z^((c2 + 1) / 2), and the exponent c3 = (q - 9) / 16",
        "// as 4-bit sliding windows: (squarings, index of the odd power",
        "// x^(2 i + 1)) pairs; index 255: squarings only.",
        _fp2("LH_SSWU_C6", _z_pow(_C2)),
        _fp2("LH_SSWU_C7", _z_pow((_C2 + 1) // 2)),
        "#define LH_C3_NWIN %d" % len(_windows(_C3, 4)),
        "LH_CONST uint8_t LH_C3_WIN[%d] = {%s};" % (
            2 * len(_windows(_C3, 4)),
            ", ".join("%d, %d" % p for p in _windows(_C3, 4))),
        "// r (8 plain words), for the signer's k mod r.",
        _words("LH_R_WORDS", [(R >> (32 * i)) & 0xFFFFFFFF
                              for i in range(8)]),
    ]
    polys = []
    for poly in (ISO3_XNUM, ISO3_XDEN, ISO3_YNUM, ISO3_YDEN):
        coeffs = list(poly) + [(0, 0)] * (4 - len(poly))
        polys.append("{" + ", ".join(_fp2_body(c) for c in coeffs) + "}")
    out.append("// XNUM, XDEN, YNUM, YDEN, low degree first, padded to 4.")
    out.append("LH_CONST fp2_t LH_ISO[4][4] = {%s};" % ", ".join(polys))
    out += [
        "",
        "// psi(x, y) = (PSI_CX conj(x), PSI_CY conj(y)).",
        _fp2("LH_PSI_CX", curve.PSI_CX),
        _fp2("LH_PSI_CY", curve.PSI_CY),
        "",
        "// G2 decompression: b = 4(1 + u), and (p - 1) / 2 (plain) for the",
        "// lexicographic sign.",
        _fp2("LH_B2", B2),
        _fp("LH_HALF_P", (P - 1) // 2, mont=False),
        "",
        "// G1: phi(x, y) = (beta x, y) acts as [lambda], lambda = z^2 - 1",
        "// (4 plain words); b = 4; (p + 1) / 4 (plain) for square roots.",
        _fp("LH_G1_BETA", curve.G1_BETA),
        _words("LH_G1_LAMBDA", [(curve.G1_LAMBDA >> (32 * i)) & 0xFFFFFFFF
                                for i in range(4)]),
        _fp("LH_B1", 4),
        _fp("LH_EXP_SQRT_P1", (P + 1) // 4, mont=False),
        "",
        "// Frobenius: coefficient (c, j) of f^(p^k) is scaled by",
        "// xi^((2j + c)(p^k - 1) / 6).",
    ]
    for k in (1, 2):
        g = tower.gamma_ints(k)
        body = ", ".join(_fp2_body(g[c][j]) for c in range(2)
                         for j in range(3))
        out.append(f"LH_CONST fp2_t LH_GAMMA{k}[6] = {{{body}}};")
    b0_blk2_tail, b0_blk3, bi_blk1_tail, bi_blk2 = hash_to_g2.xmd_templates()
    out += [
        "",
        "// The static SHA-256 blocks of expand_message_xmd for a 32-byte",
        "// message, DST = %s, len 256." % DST.decode(),
        _words("LH_XMD_B0_BLK2_TAIL", b0_blk2_tail),
        _words("LH_XMD_B0_BLK3", b0_blk3),
        _words("LH_XMD_BI_BLK1_TAIL", bi_blk1_tail),
        _words("LH_XMD_BI_BLK2", bi_blk2),
        "",
    ]
    return "\n".join(out)


def main() -> None:
    with open(HEADER, "w") as f:
        f.write(render())


if __name__ == "__main__":
    main()
