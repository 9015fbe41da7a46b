# Copied from infimum_tpu/utils/blake512.py; the port keeps its own host layers.
"""BLAKE-512 (the original SHA-3-finalist BLAKE, not BLAKE2).

circomlib/maci derive EdDSA signing scalars and nonces with BLAKE-512
(createBlakeHash("blake512")); this implementation provides byte-exact key
derivation parity so keypairs and signatures interoperate with maci-js
artifacts (reference behavior: cli's maci-domainobjs Keypair).
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_C = [
    0x243F6A8885A308D3, 0x13198A2E03707344, 0xA4093822299F31D0, 0x082EFA98EC4E6C89,
    0x452821E638D01377, 0xBE5466CF34E90C6C, 0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917,
    0x9216D5D98979FB1B, 0xD1310BA698DFB5AC, 0x2FFD72DBD01ADFB7, 0xB8E1AFED6A267E96,
    0xBA7C9045F12C7F99, 0x24A19947B3916CF7, 0x0801F2E2858EFC16, 0x636920D871574E69,
]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _rotr(x, n):
    return ((x >> n) | (x << (64 - n))) & _MASK


def _compress(h, block: bytes, t: int):
    m = [int.from_bytes(block[8 * i : 8 * i + 8], "big") for i in range(16)]
    v = h[:] + [
        _C[0], _C[1], _C[2], _C[3],
        (t & _MASK) ^ _C[4], (t & _MASK) ^ _C[5],
        ((t >> 64) & _MASK) ^ _C[6], ((t >> 64) & _MASK) ^ _C[7],
    ]

    def g(a, b, c, d, r, i):
        s = _SIGMA[r % 10]
        v[a] = (v[a] + v[b] + (m[s[2 * i]] ^ _C[s[2 * i + 1]])) & _MASK
        v[d] = _rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotr(v[b] ^ v[c], 25)
        v[a] = (v[a] + v[b] + (m[s[2 * i + 1]] ^ _C[s[2 * i]])) & _MASK
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotr(v[b] ^ v[c], 11)

    for r in range(16):
        g(0, 4, 8, 12, r, 0)
        g(1, 5, 9, 13, r, 1)
        g(2, 6, 10, 14, r, 2)
        g(3, 7, 11, 15, r, 3)
        g(0, 5, 10, 15, r, 4)
        g(1, 6, 11, 12, r, 5)
        g(2, 7, 8, 13, r, 6)
        g(3, 4, 9, 14, r, 7)

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake512(data: bytes) -> bytes:
    """BLAKE-512 digest; native C++ twin when available (two digests per
    EdDSA signature make this hot during publication)."""
    global _NATIVE
    if _NATIVE is None:
        import os

        if os.environ.get("INFIMUM_NATIVE_BLAKE", "1") != "1":
            _NATIVE = False
        else:
            from .. import native

            _NATIVE = native if native.available() else False
    if _NATIVE:
        return _NATIVE.blake512(data)
    return blake512_py(data)


_NATIVE = None


def blake512_py(data: bytes) -> bytes:
    h = _IV[:]
    bitlen = len(data) * 8
    msglen = bitlen.to_bytes(16, "big")

    pos = 0
    counter = 0
    while len(data) - pos > 128:
        counter += 1024
        h = _compress(h, data[pos : pos + 128], counter)
        pos += 128

    rest = data[pos:]
    counter += len(rest) * 8

    # padding: 0x80, zeros, 0x01, 128-bit bit length; the byte holding the
    # final pre-length padding bit has its low bit set (0x81 when they share
    # a byte). A block containing no message bits is compressed with t = 0.
    if len(rest) == 128:
        h = _compress(h, rest, counter)
        h = _compress(h, bytes([0x80]) + bytes(110) + bytes([0x01]) + msglen, 0)
    elif len(rest) == 111:
        h = _compress(h, rest + bytes([0x81]) + msglen, counter)
    elif len(rest) <= 110:
        pad = rest + bytes([0x80]) + bytes(110 - len(rest)) + bytes([0x01]) + msglen
        h = _compress(h, pad, counter)
    else:
        h = _compress(h, rest + bytes([0x80]) + bytes(127 - len(rest)), counter)
        h = _compress(h, bytes(111) + bytes([0x01]) + msglen, 0)

    return b"".join(x.to_bytes(8, "big") for x in h)
