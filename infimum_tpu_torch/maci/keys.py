# Copied from infimum_tpu/maci/keys.py; the port keeps its own host layers.
"""MACI key material: EdDSA keypairs, ECDH shared keys, EdDSA-Poseidon signatures.

Byte-exact with circomlib/maci-crypto key derivation (BLAKE-512 pruned scalars),
so keys and signatures interoperate with the reference CLI's maci-domainobjs
(reference: cli/src/user/user.ts:19-31 uses maci Keypair; circuit-side check is
circuits/utils/verify-signature.circom).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..curve import babyjubjub as bjj
from ..hash.poseidon_host import poseidon
from ..utils.blake512 import blake512


def _prune(buf: bytes) -> bytes:
    b = bytearray(buf[:32])
    b[0] &= 0xF8
    b[31] &= 0x7F
    b[31] |= 0x40
    return bytes(b)


@functools.lru_cache(maxsize=4096)
def format_priv_key(sk: int) -> int:
    """BabyJubJub scalar for ECDH/pubkey: (pruned blake512(sk))/8.
    Cached: every sign/ecdh/pub of a keypair re-derives the same scalar."""
    h1 = blake512(int(sk).to_bytes(32, "big"))
    s = int.from_bytes(_prune(h1), "little")
    return s >> 3


@dataclass
class Keypair:
    sk: int

    @functools.cached_property
    def pub(self) -> tuple[int, int]:
        return bjj.mul(bjj.BASE8, format_priv_key(self.sk))

    def ecdh(self, other_pub: tuple[int, int]) -> tuple[int, int]:
        """Shared key = formatted-sk * other_pub (a curve point)."""
        return bjj.mul(other_pub, format_priv_key(self.sk))

    def sign(self, msg: int) -> tuple[tuple[int, int], int]:
        """EdDSA-Poseidon over a field-element message; returns (R8, S)."""
        h1 = blake512(int(self.sk).to_bytes(32, "big"))
        s = int.from_bytes(_prune(h1), "little")
        a_pub = self.pub            # == s>>3 times Base8, cached
        msg_buf = int(msg).to_bytes(32, "little")
        r = int.from_bytes(blake512(h1[32:64] + msg_buf), "little") % bjj.SUB_ORDER
        r8 = bjj.mul(bjj.BASE8, r)
        hm = poseidon([r8[0], r8[1], a_pub[0], a_pub[1], msg])
        big_s = (r + hm * s) % bjj.SUB_ORDER
        return r8, big_s


def verify(pub: tuple[int, int], msg: int, sig: tuple[tuple[int, int], int]) -> bool:
    """The check the circuit performs (verify-signature.circom:17-82):
    S < subgroup order, Ax != 0, and S*B8 == R8 + h*(8*A)."""
    r8, big_s = sig
    if big_s >= bjj.SUB_ORDER:
        return False
    if pub[0] % bjj.P == 0:
        return False
    if not (bjj.is_on_curve(pub) and bjj.is_on_curve(r8)):
        return False
    hm = poseidon([r8[0], r8[1], pub[0], pub[1], msg])
    left = bjj.mul(bjj.BASE8, big_s)
    right = bjj.add(r8, bjj.mul(bjj.mul(pub, 8), hm))
    return left == right
