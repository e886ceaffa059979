"""ECRecover — secp256k1 public-key recovery (host, exact ints).

Port of `zkevm_prover_tpu/ops/ecrecover.py` (host ints) on the port's host
`keccak256`.

Reference: src/ecrecover/ecrecover.cpp:98 (`ECRecover()` over the ffiasm
fec/fnec fields, incl. sqrtF3mod4 at ecrecover.hpp:26-30) serving the EVM
ecRecover precompile and tx signature checks in the main SM.
"""

from __future__ import annotations

from . import keccak

# secp256k1 parameters
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

ECR_NO_ERROR = 0
ECR_R_IS_ZERO = 1
ECR_R_IS_TOO_BIG = 2
ECR_S_IS_ZERO = 3
ECR_S_IS_TOO_BIG = 4
ECR_V_INVALID = 5
ECR_NO_SQRT_Y = 6
ECR_INFINITY = 7


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        s = 3 * x1 * x1 * _inv(2 * y1, P) % P
    else:
        s = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (s * s - x1 - x2) % P
    return (x3, (s * (x1 - x3) - y1) % P)


def _mul(pt, k: int):
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _add(acc, add)
        add = _add(add, add)
        k >>= 1
    return acc


def sqrt_f3mod4(a: int) -> int | None:
    """Square root mod p via the p = 3 (mod 4) exponent trick — the
    reference's sqrtF3mod4 (ecrecover.hpp:26)."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def ecrecover(digest: bytes, r: int, s: int, v: int,
              precompiled: bool = False) -> tuple[int, int]:
    """Recover the signer: returns (result_code, eth_address_int).

    `v` is 27/28 (or 0/1); `precompiled` relaxes the s <= N/2 malleability
    bound the tx path enforces (reference: ECRecover modes).
    """
    if r == 0:
        return ECR_R_IS_ZERO, 0
    if r >= N:
        return ECR_R_IS_TOO_BIG, 0
    if s == 0:
        return ECR_S_IS_ZERO, 0
    s_max = N - 1 if precompiled else (N - 1) // 2
    if s > s_max:
        return ECR_S_IS_TOO_BIG, 0
    if v in (27, 28):
        parity = v - 27
    elif v in (0, 1):
        parity = v
    else:
        return ECR_V_INVALID, 0

    x = r
    y2 = (pow(x, 3, P) + B) % P
    y = sqrt_f3mod4(y2)
    if y is None:
        return ECR_NO_SQRT_Y, 0
    if y % 2 != parity:
        y = P - y

    e = int.from_bytes(digest, "big") % N
    r_inv = _inv(r, N)
    # Q = r^-1 (s·R - e·G)
    q = _add(_mul((x, y), s * r_inv % N), _mul((GX, GY), (-e * r_inv) % N))
    if q is None:
        return ECR_INFINITY, 0
    qx, qy = q
    pub = qx.to_bytes(32, "big") + qy.to_bytes(32, "big")
    addr = int.from_bytes(keccak.keccak256(pub)[12:], "big")
    return ECR_NO_ERROR, addr


def sign(digest: bytes, private_key: int, k: int) -> tuple[int, int, int]:
    """Deterministic test-vector signer (NOT for production use): returns
    (r, s, v) with low-s normalization — the oracle for ecrecover tests."""
    e = int.from_bytes(digest, "big") % N
    pt = _mul((GX, GY), k)
    r = pt[0] % N
    s = _inv(k, N) * (e + r * private_key) % N
    v = 27 + (pt[1] % 2)
    if s > (N - 1) // 2:
        s = N - s
        v = 27 + (1 - (v - 27))
    return r, s, v


def pubkey_address(private_key: int) -> int:
    pt = _mul((GX, GY), private_key)
    pub = pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
    return int.from_bytes(keccak.keccak256(pub)[12:], "big")
