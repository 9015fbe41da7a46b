"""The port's copies of the host layers against their JAX-package originals.

`infimum_tpu_torch` keeps its own copy of each pure-Python host module it
needs (fields, Poseidon, cipher, keys, trees, serialization, circuits,
witnesses, the byte-level Poseidon API, point compression). Each case runs
one piece of work through the copy and through the original on the same
inputs, from numpy seeds, and the results must be equal: hashes,
ciphertexts, roots, bytes, error classes in their order, constraint counts
and witnesses at small dims."""

import importlib
import random

import numpy as np
import pytest

from infimum_tpu.ff.bn254 import FR_MOD


def _fr(seed, n):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
            for row in words]


def poseidon_widths(m):
    h = m("hash.poseidon_host")
    out = []
    for n in range(1, 13):
        xs = _fr(n, n)
        out.append((h.poseidon(xs), h.poseidon_py(xs),
                    h.poseidon_perm([0] + xs)))
    return out


def cipher(m):
    c = m("hash.cipher")
    msg, key = _fr(20, 7), tuple(_fr(21, 2))
    ct = c.poseidon_encrypt(msg, key, 5)
    assert c.poseidon_decrypt(ct, key, 5, len(msg)) == msg
    return ct


def trees(m):
    leaves = _fr(30, 19)
    full = m("tree.full").FullTree(5, 2, 0, leaves)
    imt_mod = m("tree.imt")
    roots = []
    for arity, depth, seed in ((2, 5, True), (5, 2, False)):
        imt = imt_mod.AmortizedIMT.new(arity, depth, zero_seed=seed)
        for leaf in leaves:
            imt.insert(leaf)
        imt.merge(True)
        roots.append((imt.root, imt.depth, imt.count))
    return full.root, full.path(7), roots


def arkworks(m):
    a, bh = m("io.arkworks"), m("curve.bn254_host")
    k1, k2 = _fr(40, 2)
    p1, p2 = bh.g1_mul(bh.G1_GEN, k1), bh.g2_mul(bh.G2_GEN, k2)
    proof_bytes = {"pi_a": list(a.serialize_g1(p1)),
                   "pi_b": list(a.serialize_g2(p2)),
                   "pi_c": list(a.serialize_g1(bh.g1_add(p1, p1)))}
    proof = a.deserialize_proof(proof_bytes)
    assert a.serialize_proof(proof) == proof_bytes
    return (proof.a, proof.b, proof.c, proof_bytes,
            a.fr_to_hash_bytes(k1),
            a.fr_from_hash_bytes(a.fr_to_hash_bytes(k2)))


def zeros_and_keys(m):
    z, keys = m("tree.zeros"), m("maci.keys")
    kp = keys.Keypair(sk=_fr(50, 1)[0])
    other = keys.Keypair(sk=0xB0B)
    msg = _fr(51, 1)[0]
    sig = kp.sign(msg)
    assert keys.verify(kp.pub, msg, sig)
    return (z.blank_state_leaf(), z.merkle_zeros(2)[:4], z.merkle_zeros(5)[:4],
            z.empty_ballot_root(0), kp.pub, sig, kp.ecdh(other.pub),
            m("utils.blake512").blake512(b"infimum"))


def tally_witness(m):
    circ = m("circuits.tally").TallyCircuit(
        state_tree_depth=3, int_state_tree_depth=1, vote_option_tree_depth=1)
    wt = m("witness.tally")
    ballots = [wt.Ballot(nonce=1, votes=[0, 1, 0, 0, 0]),
               wt.Ballot(nonce=2, votes=[0, 0, 3, 0, 0])]
    builder = wt.TallyWitnessBuilder(circ, _fr(60, 1)[0], sb_salt=12345,
                                     ballots=ballots, num_signups=2)
    values, meta = builder.batch_inputs(random.Random(1))
    w = circ.assignment(values)
    assert circ.cs.check(w)
    return (len(circ.cs.constraints), circ.cs.num_vars,
            circ.public_inputs(values), meta["new_commitment"], w)


def process_witness(m):
    circ = m("circuits.process").ProcessCircuit(
        state_tree_depth=2, msg_tree_depth=1, msg_batch_depth=1,
        vote_option_tree_depth=1)
    keys, replay = m("maci.keys"), m("maci.replay")
    coord, alice = keys.Keypair(sk=777), keys.Keypair(sk=111)
    r = replay.MaciReplay(state_tree_depth=2, msg_tree_depth=1,
                          msg_batch_depth=1, vote_option_tree_depth=1,
                          coordinator=coord, poll_end_timestamp=25)
    r.sign_up(alice.pub, timestamp=2)
    packed = replay.pack_command(1, 3, 1, 1, 0, alice.pub, 99)
    sig_r8, sig_s = alice.sign(m("hash.poseidon_host").poseidon(packed))
    eph = keys.Keypair(sk=99 * 31337 + 5)
    data = m("hash.cipher").poseidon_encrypt(
        packed + [sig_r8[0], sig_r8[1], sig_s], eph.ecdh(coord.pub), 0)
    r.publish(data, eph.pub)
    builder = m("witness.process").ProcessWitnessBuilder(circ, r)
    (values, meta), = builder.batches(random.Random(1))
    w = circ.assignment(values)
    assert circ.cs.check(w)
    return (len(circ.cs.constraints), circ.cs.num_vars,
            circ.public_inputs(values), meta["new_commitment"], w)


def poseidon_bytes(m):
    """Digests in both endiannesses, and each error class, with its
    fields, in the reference's check order."""
    b = m("hash.bytes")
    xs = _fr(70, 3)
    be = b.hash_bytes_be([x.to_bytes(32, "big") for x in xs])
    le = b.hash_bytes_le([x.to_bytes(32, "little") for x in xs])
    assert be == le[::-1]
    errors = []
    for inputs in ([b""], [bytes(31)], [bytes(33)], [bytes(32)] * 13,
                   [bytes(32), b""], [bytes(31), bytes(33)],
                   [bytes(33), bytes(31)]):
        for fn in (b.hash_bytes_be, b.hash_bytes_le):
            with pytest.raises(b.PoseidonError) as e:
                fn(inputs)
            errors.append((type(e.value).__name__, str(e.value),
                           vars(e.value)))
    return be, le, errors


def pointbits(m):
    """point2bits_strict / bits2point_strict: constraint counts, the
    witness and the packed bits of a point."""
    bjj, r1cs = m("curve.babyjubjub"), m("groth16.r1cs")
    g = m("circuits.pointbits_gadget")
    p = bjj.mul(bjj.BASE8, 777)
    cs = r1cs.ConstraintSystem()
    xin, yin = cs.alloc_public(), cs.alloc_public()
    bits = g.point2bits_strict(cs, (r1cs.LC.var(xin), r1cs.LC.var(yin)))
    n_pack = len(cs.constraints)
    x2, y2 = g.bits2point_strict(cs, bits)
    cs.enforce_zero(x2 - r1cs.LC.var(xin))
    cs.enforce_zero(y2 - r1cs.LC.var(yin))
    w = cs.compute_witness({xin: p[0], yin: p[1]})
    assert cs.check(w)
    packed = sum(int(b.eval(w)) << k for k, b in enumerate(bits))
    assert packed == bjj.pack_point(p)
    return n_pack, len(cs.constraints), cs.num_vars, packed, w


CASES = {f.__name__: f for f in (poseidon_widths, cipher, trees, arkworks,
                                 zeros_and_keys, tally_witness,
                                 process_witness, poseidon_bytes,
                                 pointbits)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case):
    def loader(package):
        def m(name):
            mod = importlib.import_module(f"{package}.{name}")
            assert mod.__name__.startswith(package + ".")
            return mod
        return m

    got = CASES[case](loader("infimum_tpu_torch"))
    want = CASES[case](loader("infimum_tpu"))
    assert got == want
