"""infimum_tpu_torch must import and prove without JAX.

The machine with the GPU has no JAX, so the port and everything it imports
(the reference's host layers, reached through infimum_tpu_torch._reference)
must never import it. A subprocess installs a meta-path finder that refuses
`jax`, imports the package and its end-to-end client, proves the toy
circuit on the CPU, verifies it natively, and checks that no `jax*` module
was loaded."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import random
    import sys

    class RefuseJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("JAX refused: " + name)
            return None

    sys.meta_path.insert(0, RefuseJax())

    import infimum_tpu_torch
    import infimum_tpu_torch.client.e2e
    import infimum_tpu_torch.client.prover
    from infimum_tpu.groth16.r1cs import ConstraintSystem, LC
    from infimum_tpu.io.arkworks import serialize_proof
    from infimum_tpu_torch.groth16 import groth16 as g16

    cs = ConstraintSystem()
    prod, total = cs.alloc_public(), cs.alloc_public()
    x, y = cs.alloc(), cs.alloc()
    cs.enforce(LC.var(x), LC.var(y), LC.var(prod))
    cs.enforce_zero(LC.var(x) + LC.var(y) - LC.var(total))
    w = cs.compute_witness({prod: 21, total: 10, x: 3, y: 7})
    pk = g16.setup(cs, random.Random(42), device="cpu")
    proof = g16.prove(pk, cs, w, random.Random(43), device="cpu")
    again = g16.deserialize_proof(serialize_proof(proof))
    assert g16.verify(pk.vk, again, [21, 10])
    assert not g16.verify(pk.vk, again, [22, 10])
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    assert not loaded, loaded
    print("NOJAX-OK")
""")


def test_port_imports_and_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK" in proc.stdout
