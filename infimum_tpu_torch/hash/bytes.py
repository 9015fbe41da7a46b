# Copied from infimum_tpu/hash/bytes.py; the port keeps its own host layers.
"""Byte-level Poseidon hashing API + the light-poseidon error surface.

Mirrors the reference pallet's `PoseidonBytesHasher` trait and
`PoseidonError` enum (reference pallet/src/hash/poseidon.rs:211-251 byte
variants, :12-31 errors, :255-300 validation):

  - inputs are 32-byte strings (exactly the modulus byte length); empty
    inputs raise EmptyInput, longer-than-32 raise InvalidInputLength from
    validation, and 1..31-byte inputs pass validation but raise
    InvalidInputLength from element conversion — the reference's exact
    (quirky) two-stage check order is preserved;
  - `hash_bytes_be` reads each input big-endian, `hash_bytes_le`
    little-endian; both reduce mod r (`from_le_bytes_mod_order`
    semantics, so InputLargerThanModulus is unreachable — kept for
    parity with the reference enum);
  - the 32-byte digest comes back in the matching endianness.
"""

from __future__ import annotations

from ..ff.bn254 import FR_MOD
from .poseidon_host import poseidon

HASH_LEN = 32
_MODULUS_BYTES = 32


class PoseidonError(Exception):
    """Base of the reference PoseidonError enum (poseidon.rs:12-31)."""


class InvalidNumberOfInputs(PoseidonError):
    def __init__(self, inputs: int, max_limit: int, width: int):
        super().__init__(
            f"invalid number of inputs {inputs} (max {max_limit}, "
            f"width {width})")
        self.inputs, self.max_limit, self.width = inputs, max_limit, width


class EmptyInput(PoseidonError):
    pass


class InvalidInputLength(PoseidonError):
    def __init__(self, length: int, modulus_bytes_len: int = _MODULUS_BYTES):
        super().__init__(
            f"invalid input length {length} (modulus is "
            f"{modulus_bytes_len} bytes)")
        self.len, self.modulus_bytes_len = length, modulus_bytes_len


class InputLargerThanModulus(PoseidonError):
    pass


class InvalidWidthCircom(PoseidonError):
    def __init__(self, width: int, max_limit: int):
        super().__init__(f"invalid circom width {width} (max {max_limit})")
        self.width, self.max_limit = width, max_limit


def validate_bytes_length(data: bytes) -> None:
    """poseidon.rs:255-273: empty or longer than the modulus rejects."""
    if len(data) == 0:
        raise EmptyInput()
    if len(data) > _MODULUS_BYTES:
        raise InvalidInputLength(len(data))


def bytes_to_field_element(data: bytes) -> int:
    """poseidon.rs:276-300: exactly 32 little-endian bytes, reduced mod r."""
    if len(data) != _MODULUS_BYTES:
        raise InvalidInputLength(len(data))
    return int.from_bytes(data, "little") % FR_MOD


def _hash_elems(elems: list[int]) -> int:
    if not 1 <= len(elems) <= 12:
        # the reference's fixed-width hasher rejects with the requested
        # width (poseidon.rs:162-171); MAX_X5_LEN = 13 => 12 inputs
        raise InvalidNumberOfInputs(len(elems), 12, len(elems) + 1)
    return poseidon(elems)


def hash_bytes_be(inputs: list[bytes]) -> bytes:
    """Hash big-endian 32-byte field encodings -> big-endian 32B digest
    (poseidon.rs:213-232: reverse, convert LE, hash, reverse back)."""
    elems = []
    for data in inputs:
        validate_bytes_length(data)
        elems.append(bytes_to_field_element(bytes(reversed(data))))
    return _hash_elems(elems).to_bytes(HASH_LEN, "big")


def hash_bytes_le(inputs: list[bytes]) -> bytes:
    """Hash little-endian 32-byte field encodings -> little-endian digest
    (poseidon.rs:234-251)."""
    elems = []
    for data in inputs:
        validate_bytes_length(data)
        elems.append(bytes_to_field_element(data))
    return _hash_elems(elems).to_bytes(HASH_LEN, "little")
