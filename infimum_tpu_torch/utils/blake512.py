# Counterpart of infimum_tpu/utils/blake512.py, whose Python twin the tests
# hold the native digest against; the port keeps its own host layers.
"""BLAKE-512 (the original SHA-3-finalist BLAKE, not BLAKE2).

circomlib/maci derive EdDSA signing scalars and nonces with BLAKE-512
(createBlakeHash("blake512")); the native digest provides byte-exact key
derivation parity so keypairs and signatures interoperate with maci-js
artifacts (reference behavior: cli's maci-domainobjs Keypair).
"""

from __future__ import annotations

from .. import native


def blake512(data: bytes) -> bytes:
    """BLAKE-512 digest, in native C++ (native/src/blake512.cc; two digests
    per EdDSA signature make this hot during publication)."""
    return native.blake512(data)
