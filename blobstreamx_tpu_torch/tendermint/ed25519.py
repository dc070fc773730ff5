"""Ed25519 (RFC 8032) — native host implementation.

The port's copy of ``blobstreamx_tpu/tendermint/ed25519.py``.

Capability parity with the reference's native signature layer
(`ed25519-consensus` used by tendermintx, SURVEY.md D11 — Cargo.lock:4683).
Used for witness generation (decompressed points, scalar reductions,
double-and-add intermediate states feed the EC chip trace) and for
native-side pre-checks in the operator (`is_valid_skip`).

Pure-python integer arithmetic; the batched in-circuit version lives in
chips/ed25519.py. Verification is cofactorless ([S]B == R + [k]A with
canonical decompression) — strictly stronger than ZIP215 batch rules, so
every honestly-produced Tendermint signature passes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

# field / curve parameters
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# extended twisted Edwards coordinates (X, Y, Z, T), -x^2+y^2 = 1+d x^2 y^2
Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)

BASE_Y = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


BASE: Point = (_recover_x(BASE_Y, 0), BASE_Y, 1, _recover_x(BASE_Y, 0) * BASE_Y % P)


def point_add(p: Point, q: Point) -> Point:
    """Unified a=-1 extended-coordinates addition (also used for doubling).

    Mirrors the 9-multiplication dataflow proven by the EC chip:
      A=(Y1-X1)(Y2-X2) B=(Y1+X1)(Y2+X2) C=T1*T2 C2=2d*C D=2*Z1*Z2
      E=B-A F=D-C2 G=D+C2 H=B+A -> X3=EF Y3=GH T3=EH Z3=FG
    """
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * t2 % P
    c2 = 2 * D * c % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (dd - c2) % P, (dd + c2) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def scalar_mul(k: int, p: Point) -> Point:
    acc = IDENTITY
    while k:
        if k & 1:
            acc = point_add(acc, p)
        p = point_add(p, p)
        k >>= 1
    return acc


def point_equal(p: Point, q: Point) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def decompress(data: bytes) -> Optional[Point]:
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little") & ((1 << 255) - 1)
    sign = data[31] >> 7
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def compress(p: Point) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def challenge_scalar(r_bytes: bytes, a_bytes: bytes, msg: bytes) -> int:
    """k = SHA512(R || A || M) interpreted little-endian, mod L."""
    h = hashlib.sha512(r_bytes + a_bytes + msg).digest()
    return int.from_bytes(h, "little") % L


def verify(public_key: bytes, msg: bytes, signature: bytes) -> bool:
    """Cofactorless RFC 8032 verification: [S]B == R + [k]A."""
    if len(signature) != 64:
        return False
    a = decompress(public_key)
    r = decompress(signature[:32])
    if a is None or r is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = challenge_scalar(signature[:32], public_key, msg)
    sb = scalar_mul(s, BASE)
    rka = point_add(r, scalar_mul(k, a))
    return point_equal(sb, rka)


@dataclass
class VerifyWitness:
    """Intermediate values consumed by the EC chip trace builder."""

    a: Point
    r: Point
    s: int
    k: int  # reduced challenge scalar
    k512: int  # full 512-bit pre-reduction value
    valid: bool


def verify_witness(public_key: bytes, msg: bytes, signature: bytes) -> VerifyWitness:
    a = decompress(public_key)
    r = decompress(signature[:32])
    assert a is not None and r is not None, "non-canonical point encoding"
    s = int.from_bytes(signature[32:], "little")
    h = hashlib.sha512(signature[:32] + public_key + msg).digest()
    k512 = int.from_bytes(h, "little")
    k = k512 % L
    sb = scalar_mul(s, BASE)
    rka = point_add(r, scalar_mul(k, a))
    return VerifyWitness(a=a, r=r, s=s, k=k, k512=k512, valid=point_equal(sb, rka))


# ---------------------------------------------------------------------------
# signing (RFC 8032 — for the synthetic test chain, testing/synthetic.py;
# the reference repo never signs, but its fixtures were signed by real
# validators: this is the "record fixtures" capability without a network)
# ---------------------------------------------------------------------------

def secret_expand(seed: bytes) -> Tuple[int, bytes]:
    """seed (32B) -> (clamped scalar, hash prefix for nonces)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]

def public_key(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return compress(scalar_mul(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signature (64 bytes)."""
    a, prefix = secret_expand(seed)
    A = public_key(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = compress(scalar_mul(r, BASE))
    k = challenge_scalar(R, A, msg)
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")
