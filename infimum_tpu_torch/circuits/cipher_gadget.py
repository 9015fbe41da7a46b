# Copied from infimum_tpu/circuits/cipher_gadget.py; the port keeps its own host layers.
"""Poseidon-cipher decryption gadget (non-authenticating).

Statement equivalent of PoseidonDecryptWithoutCheck
(circuits/utils/poseidon-cipher.circom:63-159): duplex sponge over the
Poseidon permutation with state [0, k0, k1, nonce + len*2^128]; each
iteration releases 3 plaintext words and absorbs the 3 ciphertext words."""

from __future__ import annotations

from ..groth16.r1cs import ConstraintSystem, LC
from .gadgets import poseidon_perm_gadget

TWO_128 = 1 << 128


def poseidon_decrypt_gadget(cs: ConstraintSystem, ciphertext: list[LC],
                            key: tuple[LC, LC], nonce: LC,
                            length: int) -> list[LC]:
    """ciphertext: decryptedLength+1 words; returns decryptedLength words
    (padded length, multiple of 3). No tag/padding enforcement."""
    decrypted_length = length
    while decrypted_length % 3 != 0:
        decrypted_length += 1
    assert len(ciphertext) == decrypted_length + 1

    state = [LC.const(0), key[0], key[1], nonce + LC.const(length * TWO_128)]
    decrypted: list[LC] = []
    for i in range(decrypted_length // 3):
        state = poseidon_perm_gadget(cs, state)
        for j in range(3):
            decrypted.append(ciphertext[3 * i + j] - state[j + 1])
        state = [state[0]] + list(ciphertext[3 * i : 3 * i + 3])
    return decrypted
