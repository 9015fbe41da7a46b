"""infimum_tpu_torch must import and prove without JAX or the JAX package.

The machine with the GPU has no JAX, and the port keeps its own copies of
the host layers it needs, so neither `jax` nor `infimum_tpu` may be
imported by it. A subprocess installs a meta-path finder that refuses both,
imports the package, its end-to-end and scale-poll clients, user roles,
pallet, key cache, stage trace, pairing, its Poseidon and tree modules, the
zkey path, the byte-level Poseidon API, point compression and the witness
workers, builds the toy circuit with the port's own r1cs, sets it up
through the key cache (a miss, then a hit), proves it on the CPU, verifies
it natively and by the pure-Python pairing, then generates its zkey, writes
and reads it, proves from it and verifies, and checks that no `jax*` or
`infimum_tpu*` module was loaded."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import random
    import sys
    import tempfile

    REFUSED = ("jax", "jaxlib", "infimum_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())

    import infimum_tpu_torch
    import infimum_tpu_torch.client.e2e
    import infimum_tpu_torch.client.prover
    import infimum_tpu_torch.client.scale
    import infimum_tpu_torch.client.user
    import infimum_tpu_torch.circuits.pointbits_gadget
    import infimum_tpu_torch.curve.pairing
    import infimum_tpu_torch.hash.bytes
    import infimum_tpu_torch.hash.poseidon
    import infimum_tpu_torch.io.snarkjs_json
    import infimum_tpu_torch.witness.parallel
    import infimum_tpu_torch.pallet
    import infimum_tpu_torch.pallet.dispatch
    import infimum_tpu_torch.parallel.tree
    import infimum_tpu_torch.utils.profiling
    from infimum_tpu_torch.groth16 import groth16 as g16
    from infimum_tpu_torch.groth16.pkcache import setup_cached
    from infimum_tpu_torch.groth16 import zkey
    from infimum_tpu_torch.groth16.r1cs import ConstraintSystem, LC
    from infimum_tpu_torch.io import snarkjs
    from infimum_tpu_torch.io.arkworks import (
        deserialize_proof, serialize_proof,
    )

    cs = ConstraintSystem()
    prod, total = cs.alloc_public(), cs.alloc_public()
    x, y = cs.alloc(), cs.alloc()
    cs.enforce(LC.var(x), LC.var(y), LC.var(prod))
    cs.enforce_zero(LC.var(x) + LC.var(y) - LC.var(total))
    w = cs.compute_witness({prod: 21, total: 10, x: 3, y: 7})
    with tempfile.TemporaryDirectory() as cache:
        pk = setup_cached(cs, random.Random(42), "toy", cache, device="cpu")
        assert setup_cached(cs, random.Random(42), "toy", cache,
                            device="cpu").vk == pk.vk
    proof = g16.prove(pk, cs, w, random.Random(43), device="cpu")
    assert list(g16.LAST_PROVE_TRACE) == [
        "h_dispatch", "witness_limbs", "msm_dispatch", "msm_wait"]
    again = deserialize_proof(serialize_proof(proof))
    assert type(again) is g16.Proof
    assert g16.verify(pk.vk, again, [21, 10])
    assert not g16.verify(pk.vk, again, [22, 10])
    assert g16.verify_py(pk.vk, again, [21, 10])
    zk = snarkjs.read_zkey(snarkjs.write_zkey(
        zkey.generate_zkey(cs, random.Random(44), device="cpu")))
    zproof = zkey.prove_zkey(zk, w, random.Random(45), device="cpu")
    assert g16.verify(zkey.vk_from_zkey(zk), zproof, [21, 10])
    assert not g16.verify(zkey.vk_from_zkey(zk), zproof, [22, 10])
    loaded = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not loaded, loaded
    print("NOJAX-OK")
""")


def test_port_imports_and_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK" in proc.stdout
