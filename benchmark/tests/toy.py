"""A toy cell for the CPU tests: a small circuit with full-width
constants, its key from a seed, one witness, deployed on the CPU."""

import bench_paths  # noqa: F401  (sys.path for the harness)

import functools
import random
from types import SimpleNamespace

from harness.cell import Deployment, Inputs
from harness.reference import Groth16Reference, circuit_shape
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.groth16.r1cs import LC, ConstraintSystem

KEY_SEED = 20261020


@functools.lru_cache(maxsize=None)
def toy_cell(n: int = 24, copies: int = 1):
    """(Deployment, Inputs, Groth16Reference): out = x prod_i (x + k_i),
    its one witness `copies` times over; the configuration pins the toy
    circuit's shape."""
    ks = [random.Random(i).randrange(g16.P) for i in range(n)]
    cs = ConstraintSystem()
    out = cs.alloc_public()
    x = cs.alloc()
    acc = LC.var(x)
    for k in ks:
        acc = cs.mul(acc, LC.var(x) + LC.const(k))
    cs.enforce_zero(acc - LC.var(out))
    xv = 987654321987654321
    v = xv
    for k in ks:
        v = v * (xv + k) % g16.P
    witness = cs.compute_witness({out: v, x: xv})
    pk = g16.setup(cs, random.Random(KEY_SEED), device="cpu")
    config = {"key_seed": KEY_SEED, "circuits": {"toy": circuit_shape(cs)}}
    dep = Deployment(config, {"circuit": "toy", "witnesses": copies},
                     None, SimpleNamespace(cs=cs), pk, "cpu")
    inputs = Inputs([witness] * copies,
                    [witness[1:cs.num_public + 1]] * copies)
    return dep, inputs, Groth16Reference(cs, KEY_SEED)
