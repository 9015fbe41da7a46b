"""How `correct` is decided: every proof the window produced against the
plain reference (reference.py), once the window has closed.

The numbers compared, each with its limit:

- `wrong_points`: points (A, B or C) of the window's proofs that differ
  from the reference's for the same witness, r and s. The comparison is
  exact, so its limit is 0.
- `failed_proofs`: proofs that raised or did not verify. Limit 0.
- `accepted_bad_proofs`: proofs the program's `verify` accepts that it
  must refuse, one a witness on that witness's public inputs (`bad_proofs`).
  Limit 0: the window's verify is held to its answer both ways.
- `circuit_mismatch`: fields of the constraint system's shape (rows,
  variables, public inputs, the rows' digest: `reference.circuit_shape`)
  that differ from those the configuration pins for the circuit. Limit 0:
  the circuit and its key are the deployment's, and a smaller one proves
  faster.

The control (`control_prove`) stands in for the program: the reference's
own proof with every witness scalar of the four witness MSMs (a, b1, b2,
l) cut to its low `CONTROL_BITS` bits, as an MSM that drops its top
windows would compute it. It has to come out as not correct.
"""

from __future__ import annotations

import random

from .bn254 import R, g1_mul, g2_mul
from .reference import Groth16Reference, circuit_shape, proof_randomness

LIMITS = {"wrong_points": 0, "failed_proofs": 0, "accepted_bad_proofs": 0,
          "circuit_mismatch": 0}
CONTROL_BITS = 128


def compare(ref: Groth16Reference, cs, pinned: dict,
            witnesses: list[list[int]], publics: list[list[int]], records,
            verify, proof_cls, seed: int) -> dict:
    """{name: value} of the numbers compared over `records`, the circuit
    `cs` against its `pinned` shape, and `verify(proof, public_inputs)` (the
    program's) against the bad proofs made with `proof_cls` from `seed`."""
    sums = [ref.witness_sums(w) for w in witnesses]
    wrong = failed = 0
    for rec in records:
        failed += not rec.ok
        if rec.proof is None:
            continue
        r, s = proof_randomness(random.Random(rec.seed))
        want = ref.proof(sums[rec.witness], r, s)
        got = (rec.proof.a, rec.proof.b, rec.proof.c)
        wrong += sum(g != w for g, w in zip(got, want))
    shape = circuit_shape(cs)
    accepted = sum(bool(verify(proof, pub)) for proof, pub in
                   bad_proofs(ref, sums, publics, proof_cls, seed))
    return {"wrong_points": wrong, "failed_proofs": failed,
            "accepted_bad_proofs": accepted,
            "circuit_mismatch": sum(shape[k] != pinned.get(k)
                                    for k in shape)}


def bad_proofs(ref: Groth16Reference, sums: list, publics: list[list[int]],
               proof_cls, seed: int):
    """(proof, public inputs) a verifier must refuse, one a witness: the
    reference's proof of it under r and s drawn from `seed`, with C moved
    by the generator (even witnesses), or on its public inputs with the
    first moved by one (odd)."""
    rng = random.Random(seed)
    for k, (ws, pub) in enumerate(zip(sums, publics)):
        sa, sb, sc = ref.scalars(ws, *proof_randomness(rng))
        pub = list(pub)
        if k % 2:
            pub[0] = (pub[0] + 1) % R
        else:
            sc += 1
        yield proof_cls(g1_mul(sa), g2_mul(sb), g1_mul(sc)), pub


def verdict(numbers: dict, attempted: int) -> bool:
    return attempted > 0 and all(numbers[k] <= lim
                                 for k, lim in LIMITS.items())


def compared_line(numbers: dict) -> dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}


def control_prove(ref: Groth16Reference, proof_cls):
    """A prover with the program's signature whose proofs are the control's:
    the reference with the witness MSMs' scalars cut to CONTROL_BITS bits,
    h(tau) Z(tau) kept whole."""
    mask = (1 << CONTROL_BITS) - 1
    cache = {}

    def prove(dep, witness, rng):
        key = id(witness)
        if key not in cache:
            hz = ref.witness_sums(witness)[3]
            cut = ref.witness_sums([x & mask for x in witness])
            cache[key] = (*cut[:3], hz)
        r, s = proof_randomness(rng)
        return proof_cls(*ref.proof(cache[key], r, s))
    return prove
