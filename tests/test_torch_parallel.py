"""The port's sharded MSM, NTT and Merkle build over torch.distributed,
held against the JAX package's `infimum_tpu/parallel/` on the CPU.

Each world of ranks (2, 4, 5 and 8 processes over gloo, started by
`infimum_tpu_torch.parallel.distributed.spawn`) runs all of its cases in
one go, in a background thread, while the JAX references compile here on
conftest's 8 virtual CPU devices. Inputs come from seeds. Every comparison
is exact: equal ints, equal limbs, equal affine points."""

import concurrent.futures
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from infimum_tpu.curve.bn254_host import (
    G1_GEN, G2_GEN, g1_mul, g2_mul, msm_host_fast,
)
from infimum_tpu.curve.proj import G1_DEV
from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.ff.fp import FR_CTX as REF_FR
from infimum_tpu.msm.pippenger import msm_host
from infimum_tpu.ntt.ntt import ntt_host
from infimum_tpu.parallel import msm as ref_msm
from infimum_tpu.parallel import ntt as ref_ntt
from infimum_tpu.parallel import tree as ref_tree
from infimum_tpu.tree.full import FullTree

from infimum_tpu_torch.parallel import distributed as D
from infimum_tpu_torch.parallel import msm as PM
from infimum_tpu_torch.parallel import ntt as PN
from infimum_tpu_torch.parallel import tree as PT

NTT_LOGNS = (6, 8)


def _inputs():
    rng = random.Random(2026)
    ntt = {logn: [rng.randrange(FR_MOD) for _ in range(1 << logn)]
           for logn in NTT_LOGNS}
    g1 = ([g1_mul(G1_GEN, rng.randrange(1, 10_000)) for _ in range(16)],
          [rng.randrange(FR_MOD) for _ in range(16)])
    g2 = ([g2_mul(G2_GEN, rng.randrange(1, 10_000)) for _ in range(8)],
          [rng.randrange(FR_MOD) for _ in range(8)])
    binary = [rng.randrange(FR_MOD) for _ in range(23)]
    quinary = [rng.randrange(FR_MOD) for _ in range(101)]
    return {"ntt": ntt, "g1": g1, "g2": g2, "binary": binary,
            "quinary": quinary}


INPUTS = _inputs()
# what each world runs, in the order the tests first need them: NTT at
# every world size; G1 at the reference test's shape (16 points, 8 ranks)
# both ways and at 5 ranks by gather; G2 at 4 ranks; the binary tree over
# 8 ranks and the quinary over 5, each also where the group is not a power
# of its arity
WORLDS = {
    2: {"ntt": True, "collectives": True},
    4: {"ntt": True, "msm": [("g2", ("gather", "permute"))]},
    8: {"ntt": True, "msm": [("g1", ("gather", "permute"))],
        "tree": [(2, 5, "binary"), (5, 3, "quinary")]},
    5: {"msm": [("g1", ("gather", "permute"))],
        "tree": [(5, 3, "quinary"), (2, 5, "binary")]},
}


def _attempt(fn, *args):
    """fn's result, or the ValueError it raised (for the refusals)."""
    try:
        return fn(*args)
    except ValueError as e:
        return e


def _collectives(mesh) -> dict:
    """Each helper of `distributed` once, with the bytes it counts."""
    mesh.sent = mesh.received = 0
    me = torch.full((3,), mesh.rank, dtype=torch.int32)
    gathered = D.all_gather(me, mesh)
    blocks = torch.arange(2 * mesh.world, dtype=torch.int32) + 10 * mesh.rank
    swapped = D.all_to_all(blocks, mesh)
    if mesh.rank == 1:
        D.send(torch.tensor([7, 8], dtype=torch.int64), 0, mesh)
        got = None
    else:
        got = D.recv(torch.zeros(2, dtype=torch.int64), 1, mesh).tolist()
    D.barrier(mesh)
    return {"gathered": gathered.tolist(), "swapped": swapped.tolist(),
            "received_pair": got, "sent": mesh.sent,
            "received": mesh.received}


def _rank(mesh, work: dict) -> dict:
    """One rank of a test world: every case of `work`."""
    out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
           "shard": D.host_shard(8 * mesh.world, mesh)}
    if work.get("ntt"):
        for logn in NTT_LOGNS:
            values = INPUTS["ntt"][logn]
            fn, logn2, logn1 = PN.make_ntt_sharded(mesh, logn)
            out["slab", logn] = fn(PN.column_slab(values, mesh, logn2,
                                                  logn1)).numpy()
            out["ntt", logn] = PN.ntt_sharded(values, mesh)
            out["roundtrip", logn] = PN.intt_roundtrip_sharded(values, mesh)
    for curve, modes in work.get("msm", ()):
        points, scalars = INPUTS[curve]
        for mode in modes:
            mesh.sent = mesh.received = 0
            got = _attempt(PM.msm_sharded, points, scalars, mesh, curve,
                           mode)
            out["msm", curve, mode] = (got, mesh.sent, mesh.received)
    for arity, depth, name in work.get("tree", ()):
        out["tree", arity] = _attempt(PT.sharded_tree_root, mesh, arity,
                                      depth, INPUTS[name])
    if work.get("collectives"):
        out["collectives"] = _collectives(mesh)
    return out


@pytest.fixture(scope="module")
def worlds():
    """Each world's per-rank results, as futures: the worlds run one after
    another in a background thread, each rank a spawned process."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    futs = {d: pool.submit(D.spawn, _rank, d, "gloo", "cpu", (work,), 240)
            for d, work in WORLDS.items()}
    yield {d: (lambda f=f: f.result(timeout=600)) for d, f in futs.items()}
    pool.shutdown(wait=True, cancel_futures=True)


def _mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("dp",))


def _ref_kform(logn):
    """The reference's sharded forward NTT at 8 devices: its (N2, N1, 16)
    k-form and its shards in device order."""
    mesh = _mesh(8)
    fn, logn2, logn1 = ref_ntt.make_ntt_sharded(mesh, "dp", logn)
    enc = np.asarray(REF_FR.encode(INPUTS["ntt"][logn])).reshape(
        1 << logn2, 1 << logn1, -1)
    out = jax.jit(fn)(jax.device_put(jnp.asarray(enc),
                                     NamedSharding(mesh, P(None, "dp"))))
    shards = sorted(out.addressable_shards, key=lambda s: s.index[0].start)
    return np.asarray(out), [np.asarray(s.data) for s in shards]


@pytest.fixture(scope="module")
def ref_kforms():
    return {logn: _ref_kform(logn) for logn in NTT_LOGNS}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("d", [2, 4, 8])
def test_ntt_sharded_matches_reference(worlds, ref_kforms, d):
    """Each rank's k-form slab equals the reference's shard limb for limb,
    and `ntt_sharded` equals the reference's ints on every rank. The
    reference splits 2^6 and 2^8 alike at 2, 4 and 8 devices, so its
    shard at d devices is rows [r N2/d, (r+1) N2/d) of its k-form at 8
    (at 8, its own shards)."""
    ranks = worlds[d]()
    for logn in NTT_LOGNS:
        kform, shards8 = ref_kforms[logn]
        assert len({ref_ntt._split(logn, k) for k in (2, 4, 8)}) == 1
        assert ref_ntt._split(logn, d) == PN._split(logn, d)
        rows = kform.shape[0] // d
        want = ntt_host(INPUTS["ntt"][logn])
        for r in ranks:
            slab = r["slab", logn]
            assert np.array_equal(slab, kform[r["rank"] * rows:
                                              (r["rank"] + 1) * rows])
            if d == 8:
                assert np.array_equal(slab, shards8[r["rank"]])
            assert r["ntt", logn] == want
        # the reference's `ntt_sharded` ints, read from the same k-form
        n = kform.shape[0] * kform.shape[1]
        assert REF_FR.decode(kform.transpose(1, 0, 2).reshape(n, -1)) == \
            want


@pytest.mark.timeout(600)
@pytest.mark.parametrize("d", [2, 4, 8])
def test_intt_roundtrip_sharded(worlds, d):
    """NTT then iNTT over d ranks gives back the input on every rank, as
    the reference's `intt_roundtrip_sharded` does."""
    for r in worlds[d]():
        for logn in NTT_LOGNS:
            assert r["roundtrip", logn] == INPUTS["ntt"][logn]


@pytest.mark.timeout(600)
def test_msm_sharded_g1_8_ranks(worlds):
    """G1 at the reference test's shape (16 points, 8 ranks): equal to the
    reference's `msm_sharded(..., c=4, lanes=2)` and to `msm_host`; gather
    (every rank holds the sum) equals permute (rank 0 holds it)."""
    points, scalars = INPUTS["g1"]
    want = msm_host(points, scalars)
    assert ref_msm.msm_sharded(points, scalars, _mesh(8), c=4,
                               lanes=2) == want
    ranks = worlds[8]()
    for r in ranks:
        assert r["msm", "g1", "gather"][0] == want
        assert r["msm", "g1", "permute"][0] == (want if r["rank"] == 0
                                                 else None)


@pytest.mark.timeout(600)
def test_msm_sharded_g2_4_ranks(worlds):
    points, scalars = INPUTS["g2"]
    want = msm_host_fast(points, scalars, "g2")
    ranks = worlds[4]()
    assert [r["msm", "g2", "gather"][0] for r in ranks] == [want] * 4
    assert ranks[0]["msm", "g2", "permute"][0] == want


@pytest.mark.timeout(600)
def test_msm_sharded_5_ranks_gathers(worlds):
    """Five ranks: the gather reduction pads the tree with the identity
    (and the last rank's share is empty); permute refuses the group."""
    points, scalars = INPUTS["g1"]
    ranks = worlds[5]()
    for r in ranks:
        assert r["msm", "g1", "gather"][0] == msm_host(points, scalars)
        assert isinstance(r["msm", "g1", "permute"][0], ValueError)


@pytest.mark.timeout(600)
def test_reduction_comm_bytes(worlds):
    """The modes and rounds are the reference's; permute moves less than
    gather for D > 2; and what the collectives counted equals the model."""
    for d in (1, 2, 3, 4, 5, 8):
        for curve in ("g1", "g2"):
            for mode in ("auto", "gather") + (
                    ("permute",) if d & (d - 1) == 0 else ()):
                got = PM.reduction_comm_bytes(d, curve, mode)
                ref = ref_msm.reduction_comm_bytes(d, G1_DEV, 4, mode)
                assert (got["mode"], got["rounds"]) == (ref["mode"],
                                                        ref["rounds"])
    for d in (4, 8):
        assert (PM.reduction_comm_bytes(d, "g1", "permute")
                ["per_device_bytes"] < PM.reduction_comm_bytes(
                    d, "g1", "gather")["per_device_bytes"])
    assert PM.reduction_comm_bytes(1, "g2")["window_payload_bytes"] == 4992
    for d, curve in ((8, "g1"), (4, "g2"), (5, "g1")):
        ranks = worlds[d]()
        gather = PM.reduction_comm_bytes(d, curve, "gather")
        for r in ranks:
            _, sent, received = r["msm", curve, "gather"]
            assert sent == received == gather["per_device_bytes"]
        if d & (d - 1) == 0:
            permute = PM.reduction_comm_bytes(d, curve, "permute")
            assert max(r["msm", curve, "permute"][2] for r in ranks) == \
                ranks[0]["msm", curve, "permute"][2] == \
                permute["per_device_bytes"]
            assert sum(r["msm", curve, "permute"][1] for r in ranks) == \
                (d - 1) * permute["window_payload_bytes"]


@pytest.mark.timeout(600)
def test_sharded_tree_binary_8_ranks(worlds):
    leaves = INPUTS["binary"]
    want = ref_tree.sharded_tree_root(_mesh(8), "dp", 2, 5, leaves)
    assert want == ref_tree.host_tree_root(2, 5, leaves) == \
        FullTree(2, 5, 0, leaves).root
    assert [r["tree", 2] for r in worlds[8]()] == [want] * 8


@pytest.mark.timeout(600)
def test_sharded_tree_quinary_5_ranks(worlds):
    leaves = INPUTS["quinary"]
    want = ref_tree.sharded_tree_root(_mesh(5), "dp", 5, 3, leaves)
    assert want == ref_tree.host_tree_root(5, 3, leaves) == \
        FullTree(5, 3, 0, leaves).root
    assert [r["tree", 5] for r in worlds[5]()] == [want] * 5


@pytest.mark.timeout(600)
def test_tree_group_not_power_of_arity_raises(worlds):
    """A binary tree over 5 ranks and a quinary tree over 8 are refused on
    every rank, as the reference refuses such meshes."""
    for d, arity in ((5, 2), (8, 5)):
        for r in worlds[d]():
            assert isinstance(r["tree", arity], ValueError)
        with pytest.raises(ValueError):
            ref_tree.make_tree_builder(_mesh(d), "dp", arity, 5)


@pytest.mark.timeout(600)
def test_initialize_without_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize("gloo") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize("gloo") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.timeout(600)
def test_host_shard_and_proving_mesh_world_1():
    mesh = D.proving_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.device.type, mesh.group) == (
        0, 1, "cpu", None)
    assert D.host_shard(64, mesh) == slice(0, 64)
    local = np.arange(64, dtype=np.int32).reshape(8, 8)
    arr = D.global_array(local, mesh)
    assert arr.device.type == "cpu" and np.array_equal(arr.numpy(), local)
    # a world of one without a group: the collectives are local
    x = torch.arange(4)
    assert torch.equal(D.all_gather(x, mesh), x[None])
    assert torch.equal(D.all_to_all(x, mesh), x)
    assert PT.sharded_tree_root(mesh, 2, 3, INPUTS["binary"][:5]) == \
        ref_tree.host_tree_root(2, 3, INPUTS["binary"][:5])


@pytest.mark.timeout(600)
def test_two_process_gloo_group(worlds):
    """Two spawned ranks form a gloo group; each helper moves what it
    should and counts its bytes."""
    ranks = worlds[2]()
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    assert [r["shard"] for r in ranks] == [slice(0, 8), slice(8, 16)]
    for r in ranks:
        c = r["collectives"]
        assert c["gathered"] == [[0] * 3, [1] * 3]
        me = r["rank"]
        assert c["swapped"] == [2 * me, 2 * me + 1, 10 + 2 * me,
                                11 + 2 * me]
    c0, c1 = ranks[0]["collectives"], ranks[1]["collectives"]
    assert c0["received_pair"] == [7, 8] and c1["received_pair"] is None
    # all_gather 12 bytes each way, all_to_all 8, the pair 16 from rank 1
    assert (c0["sent"], c0["received"]) == (20, 36)
    assert (c1["sent"], c1["received"]) == (36, 20)
    with pytest.raises(ValueError):
        D.host_shard(7, D.ProvingMesh(0, 2, torch.device("cpu")))
