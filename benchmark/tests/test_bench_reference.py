"""The plain reference on a toy circuit: the program's proofs on the CPU
equal the reference's, its curve arithmetic equals the program's, and
nothing of the program is imported by it."""

import bench_paths  # noqa: F401  (sys.path for the harness)

import ast
import random
from pathlib import Path
from types import SimpleNamespace

import pytest

from harness import bn254, reference
from toy import toy_cell

HARNESS = Path(reference.__file__).parent


def test_program_proof_equals_the_reference():
    from infimum_tpu_torch.groth16 import groth16 as g16

    dep, inputs, ref = toy_cell()
    w = inputs.witnesses[0]
    proof = g16.prove(dep.pk, dep.cs, w, rng=random.Random(5), device="cpu")
    r, s = reference.proof_randomness(random.Random(5))
    assert (proof.a, proof.b, proof.c) == ref.proof(ref.witness_sums(w), r, s)
    # and a different r, s gives a different proof
    assert ref.proof(ref.witness_sums(w), r + 1, s)[0] != proof.a


def test_key_scalars_match_the_programs_setup():
    # the key's points are the trapdoor's polynomials at tau times G
    dep, _, ref = toy_cell()
    pk = dep.pk
    assert pk.alpha_g1 == bn254.g1_mul(ref.alpha)
    assert pk.delta_g2 == bn254.g2_mul(ref.delta)
    assert pk.a_query[2] == bn254.g1_mul(ref.u[2])
    assert pk.b_g2_query[2] == bn254.g2_mul(ref.v[2])


def test_curve_against_the_program():
    from infimum_tpu_torch.curve import bn254_host as host

    for k in (1, 2, 3, 2**200 + 7, bn254.R - 1):
        assert bn254.g1_mul(k) == host.g1_mul_fast(host.G1_GEN, k)
        assert bn254.g2_mul(k) == host.g2_mul_fast(host.G2_GEN, k)
    assert bn254.g1_mul(0) is None and bn254.g1_mul(bn254.R) is None


def test_circuit_shape_sees_every_row_and_coefficient():
    dep, _, _ = toy_cell()
    cs = dep.cs
    shape = reference.circuit_shape(cs)
    assert shape == {"constraints": len(cs.constraints),
                     "num_vars": cs.num_vars, "num_public": cs.num_public,
                     "rows_sha256": shape["rows_sha256"]}

    def digest(rows):
        return reference.circuit_shape(
            SimpleNamespace(constraints=rows, num_vars=cs.num_vars,
                            num_public=cs.num_public))["rows_sha256"]

    def lc(terms):
        return SimpleNamespace(terms=terms)

    rows = list(cs.constraints)
    a, b, c = rows[3]
    # terms in another order, or a coefficient not reduced, are one shape
    flipped = lc(dict(reversed(list(a.terms.items()))))
    unreduced = lc({i: k + bn254.R for i, k in b.terms.items()})
    assert digest(rows[:3] + [(flipped, unreduced, c)] + rows[4:]) == \
        shape["rows_sha256"]
    # a coefficient moved, a row dropped or two rows swapped are not
    i, k = next(iter(c.terms.items()))
    moved = lc({**c.terms, i: k + 1})
    assert digest(rows[:3] + [(a, b, moved)] + rows[4:]) != \
        shape["rows_sha256"]
    assert digest(rows[:-1]) != shape["rows_sha256"]
    assert digest([rows[1], rows[0]] + rows[2:]) != shape["rows_sha256"]


def test_lagrange_basis_sums_to_one():
    lag = reference.lagrange_at(123456789, 16, 16)
    assert sum(lag) % bn254.R == 1
    # at a domain point's neighbour, interpolation of x gives x back
    w = pow(5, (bn254.R - 1) >> 4, bn254.R)
    xs = [pow(w, j, bn254.R) for j in range(16)]
    assert sum(li * xj for li, xj in zip(lag, xs)) % bn254.R == 123456789


@pytest.mark.parametrize("name", ["reference.py", "bn254.py", "check.py"])
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse((HARNESS / name).read_text())
    mods = {n.module or "" for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    tops = {m.split(".")[0] for m in mods if m}
    assert not tops & {"infimum_tpu", "infimum_tpu_torch", "jax", "torch"}
