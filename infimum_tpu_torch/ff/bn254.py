# Copied from infimum_tpu/ff/bn254.py; the port keeps its own host layers.
"""BN254 field constants and host-side (python-int) field arithmetic.

The behavioral contract follows ark-bn254 0.4 (the verifier the reference pallet runs,
reference: pallet/src/lib.rs:815-827) and circom/snarkjs (the prover the reference CLI
runs, reference: cli/src/utils.ts:69-92).

  - Fq: base field of the BN254 (alt_bn128) pairing curve.
  - Fr: scalar field; also the field of the circuits and of Poseidon hashing
    (reference: pallet/src/hash/poseidon.rs).
"""

# Base field modulus q (order of the coordinate field of G1).
FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus r (order of G1/G2; the circuit field).
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# r - 1 = 2^28 * odd  => radix-2 NTT domains up to 2^28.
FR_TWO_ADICITY = 28

# Smallest multiplicative generator of Fr* (same as arkworks' GENERATOR = 5).
FR_GENERATOR = 5

# 2^28-th primitive root of unity: 5^((r-1) / 2^28) mod r.
FR_TWO_ADIC_ROOT = pow(FR_GENERATOR, (FR_MOD - 1) >> FR_TWO_ADICITY, FR_MOD)

# BN254 curve: y^2 = x^3 + 3 over Fq; G2 over Fq2 with b / (9 + u).
CURVE_B = 3

# BN parameter x (seed) for BN254; 6x+2 drives the ate pairing Miller loop.
BN_X = 4965661367192848881


def fr_inv(a: int) -> int:
    # extended-Euclid pow(x, -1, p) is ~50x faster than Fermat pow(x, p-2, p)
    # in CPython; keep the 0 -> 0 convention Fermat gave implicitly
    a %= FR_MOD
    return pow(a, -1, FR_MOD) if a else 0


def fq_inv(a: int) -> int:
    a %= FQ_MOD
    return pow(a, -1, FQ_MOD) if a else 0


def fr_pow(a: int, e: int) -> int:
    return pow(a % FR_MOD, e, FR_MOD)


def batch_inv_mod(vals: list[int], p: int) -> list[int]:
    """Montgomery-trick batch inversion mod p: one modexp + 3 mulmods per
    element instead of one modexp each. All vals must be nonzero mod p."""
    m = len(vals)
    pref = [1] * (m + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % p
    inv_all = pow(pref[m], p - 2, p)
    out = [0] * m
    for i in range(m - 1, -1, -1):
        out[i] = pref[i] * inv_all % p
        inv_all = inv_all * vals[i] % p
    return out


def fr_from_be_bytes_mod_order(b: bytes) -> int:
    """Match ark_ff's Fr::from_be_bytes_mod_order (reference: poll/state.rs:290)."""
    return int.from_bytes(b, "big") % FR_MOD


def fr_to_be_bytes(x: int) -> bytes:
    """Match into_bigint().to_bytes_be() zero-padded to 32 bytes."""
    return int(x % FR_MOD).to_bytes(32, "big")
