# Copied from infimum_tpu/hash/cipher.py; the port keeps its own host layers.
"""Poseidon duplex cipher (iden3 poseidon-encryption), host implementation.

Exact semantics of the reference decrypt circuit
(reference: circuits/utils/poseidon-cipher.circom:91-159): width-4 Poseidon
permutation, initial state [0, k0, k1, nonce + len*2^128], 3-element blocks,
with the final permutation's element 1 as the authentication tag.
"""

from __future__ import annotations

from ..ff.bn254 import FR_MOD
from .poseidon_host import poseidon_perm

TWO_128 = 1 << 128


def poseidon_encrypt(message: list[int], key: tuple[int, int], nonce: int) -> list[int]:
    assert nonce < TWO_128
    length = len(message)
    msg = [m % FR_MOD for m in message]
    while len(msg) % 3 != 0:
        msg.append(0)
    state = [0, key[0], key[1], (nonce + length * TWO_128) % FR_MOD]
    ciphertext = []
    for i in range(len(msg) // 3):
        state = poseidon_perm(state)
        for j in range(3):
            ciphertext.append((msg[3 * i + j] + state[j + 1]) % FR_MOD)
        state = [state[0]] + ciphertext[3 * i : 3 * i + 3]
    state = poseidon_perm(state)
    ciphertext.append(state[1])  # tag
    return ciphertext


def poseidon_decrypt(
    ciphertext: list[int], key: tuple[int, int], nonce: int, length: int,
    check: bool = True,
) -> list[int]:
    assert nonce < TWO_128
    decrypted_length = length
    while decrypted_length % 3 != 0:
        decrypted_length += 1
    assert len(ciphertext) == decrypted_length + 1
    state = [0, key[0], key[1], (nonce + length * TWO_128) % FR_MOD]
    decrypted = []
    for i in range(decrypted_length // 3):
        state = poseidon_perm(state)
        for j in range(3):
            decrypted.append((ciphertext[3 * i + j] - state[j + 1]) % FR_MOD)
        state = [state[0]] + list(ciphertext[3 * i : 3 * i + 3])
    state = poseidon_perm(state)
    if check:
        if state[1] != ciphertext[decrypted_length]:
            raise ValueError("poseidon cipher: invalid authentication tag")
        for k in range(length, decrypted_length):
            if decrypted[k] != 0:
                raise ValueError("poseidon cipher: nonzero padding")
    return decrypted[:length]
