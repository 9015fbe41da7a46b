"""Sharded MSM over a process group: the port's MSM kernels on every rank.

Counterpart of `infimum_tpu/parallel/msm.py`. Rows (points) and scalars
are sharded over the ranks; each rank runs the port's own pipeline on its
shard (`msm/msm.py` `msm_rows_words`: `lane_layout`, the accumulation
kernel, `compact`, the weighted kernel), its rows padded with zero rows
and zero scalars to its own lane count. The (nwin, PW) window sums, 20
windows for G1 (c = 13) and 26 for G2 (c = 10), stay 32-bit words through
the collectives and are summed by `point_sum` (`csrc/point_sum.cu`, one
launch a reduction or a round; `_tree_reduce_axis0` on limbs is its plain
version):

  - "gather": an all_gather of every rank's window sums, then a halving
    tree over them, padded to a power of two with the identity; every
    rank holds the sum;
  - "permute": recursive halving over log2(D) rounds of send/recv pairs,
    rank i + stride sending to rank i; rank 0 holds the sum;
  - "auto": permute for a power-of-two group, else gather.

The reference reduces window sums of its XLA Pippenger (c = 8), which the
port does not carry; the two are compared on the final point only. The
host Horner combine (`msm/msm.py` `combine_window_points`, in the native
library where it loads) runs on the ranks that hold the sum.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..curve.proj import CurveDev
from ..ff.fp import NLIMBS, limbs_to_words, words_to_limbs
from ..msm.msm import (
    SPECS, combine_window_points, encode_inputs, msm_lanes, msm_rows_words,
)
from . import distributed as D

# the sum kernel keeps a level of up to this many points a window in shared
# memory and larger levels in the scratch: csrc/point_sum.cu kLevelPoints
LEVEL_POINTS = 16


def _tree_reduce_axis0(curve: CurveDev, pts):
    """Sum (n, ...) projective points over axis 0: padded to a power of two
    with the identity, then halved, the first half plus the second, as
    the reference's masked halving does."""
    x = pts[0]
    n = x.shape[0]
    target = 1 << (n - 1).bit_length() if n > 1 else 1
    if target != n:
        inf = curve.infinity((target - n, *x.shape[1:x.dim() - curve.fdims]),
                             x.device)
        pts = tuple(torch.cat([c, i]) for c, i in zip(pts, inf))
    while target > 1:
        target //= 2
        pts = curve.add(tuple(c[:target] for c in pts),
                        tuple(c[target:] for c in pts))
    return tuple(c[0] for c in pts)


def point_sum_plain(words: torch.Tensor, curve: str = "g1") -> torch.Tensor:
    """The plain version of `point_sum` on any device: the words as limbs
    through `_tree_reduce_axis0`."""
    spec = SPECS[curve]
    limbs = words_to_limbs(words).unflatten(-1, (3, *spec.curve.fshape()))
    pts = tuple(limbs.select(2, i) for i in range(3))
    total = _tree_reduce_axis0(spec.curve, pts)
    return limbs_to_words(torch.stack(total, 1).reshape(words.shape[1],
                                                        spec.PR))


def point_sum(words: torch.Tensor, curve: str = "g1") -> torch.Tensor:
    """(D, nwin, PW) int32 projective words -> (nwin, PW) words, each
    window's D points summed in `_tree_reduce_axis0`'s order: one launch
    of the sum kernel on a card for D >= 2 (D = 1's entry is the sum),
    its plain version on the CPU."""
    if words.device.type == "cpu":
        return point_sum_plain(words, curve)
    if words.device.type != "cuda":
        raise ValueError(f"no point_sum kernel for {words.device}")
    spec = SPECS[curve]
    if words.dtype != torch.int32 or words.dim() != 3 or \
            words.shape[2] != spec.PW or not words.is_contiguous() or \
            words.shape[0] < 1:
        raise ValueError(f"words: want contiguous (D, nwin, {spec.PW}) "
                         f"int32, got {words.dtype} {tuple(words.shape)}")
    d, nwin = words.shape[:2]
    if d == 1:
        return words[0].clone()
    # T / 2 points a window, T >= d a power of 2: the levels the kernel
    # keeps out of shared memory
    half = 1 << (d - 1).bit_length() - 1
    scratch = words.new_empty((half, nwin, spec.PW)) \
        if half > LEVEL_POINTS else None
    out = words.new_empty((nwin, spec.PW))
    kernels.KERNELS[f"point_sum_{curve}"](words, scratch, out, d, nwin)
    return out


def _mode(ndev: int, reduce: str) -> str:
    if reduce == "auto":
        return "permute" if ndev & (ndev - 1) == 0 else "gather"
    if reduce not in ("gather", "permute"):
        raise ValueError(f"unknown reduction {reduce!r}")
    if reduce == "permute" and ndev & (ndev - 1):
        raise ValueError(f"the permute reduction wants a power-of-two "
                         f"group, not {ndev}")
    return reduce


def reduction_comm_bytes(ndev: int, curve: str = "g1",
                         reduce: str = "auto") -> dict:
    """Bytes one rank moves in the window reduction of one MSM.

    The payload is the window sums as 32-bit words: n_windows x PW x 4
    (G1 1,920, G2 4,992). Gather: every rank sends its payload to, and
    receives one from, each of the D - 1 others, in one round. Permute:
    one payload a round, over log2(D) rounds, received by rank 0 (each
    other rank sends one payload once)."""
    spec = SPECS[curve]
    payload = spec.n_windows * spec.PW * 4
    mode = _mode(ndev, reduce)
    if mode == "gather":
        rounds, per_dev = 1, (ndev - 1) * payload
    else:
        rounds = int(math.log2(ndev))
        per_dev = rounds * payload
    return {"mode": mode, "window_payload_bytes": payload,
            "per_device_bytes": per_dev, "rounds": rounds}


def _pad(rows, sc, lanes: int):
    """Zero rows and zero scalars up to a multiple of `lanes`."""
    n = rows.shape[0]
    npad = lanes * -(-n // lanes)
    if npad == n:
        return rows, sc
    return (torch.cat([rows, rows.new_zeros((npad - n, rows.shape[1]))]),
            torch.cat([sc, sc.new_zeros((npad - n, sc.shape[1]))]))


def make_sharded_window_sums(mesh: D.ProvingMesh, curve: str = "g1",
                             reduce: str = "auto"):
    """Returns fn(rows, sc) -> (nwin, PR) window-sum limbs of the whole
    group's MSM, or None on a rank that does not hold it (gather: every
    rank holds it; permute: rank 0). rows (n, AF) affine Montgomery limbs
    and sc (n, 16) standard-form scalar limbs are this rank's shard on its
    device, run on `msm_lanes` of the shard's size."""
    mode = _mode(mesh.world, reduce)

    def fn(rows, sc):
        lanes = msm_lanes(rows.shape[0], curve)
        words = msm_rows_words(*_pad(rows, sc, lanes), lanes, curve)
        if mode == "gather":
            return words_to_limbs(point_sum(D.all_gather(words, mesh), curve))
        stride = mesh.world >> 1
        while stride >= 1:
            if mesh.rank < stride:
                part = D.recv(words, mesh.rank + stride, mesh)
                words = point_sum(torch.stack([words, part]), curve)
            elif mesh.rank < 2 * stride:
                D.send(words, mesh.rank - stride, mesh)
            stride >>= 1
        return words_to_limbs(words) if mesh.rank == 0 else None

    return fn


def msm_sharded(points, scalars, mesh: D.ProvingMesh, curve: str = "g1",
                reduce: str = "auto"):
    """Host-level sharded MSM of host affine points (no infinities) and int
    scalars: this rank encodes its share (`host_shard` of the batch padded
    to a multiple of the world), the group reduces, and the ranks holding
    the sum combine it on the host. Returns the affine point there (None
    for the identity), and None on the other ranks."""
    per = -(-len(points) // mesh.world)
    sl = D.host_shard(per * mesh.world, mesh)
    mine, my_sc = points[sl], scalars[sl]
    if mine:
        rows, sc = encode_inputs(mine, my_sc, msm_lanes(len(mine), curve),
                                 curve, mesh.device)
    else:                               # an empty share: zero rows
        rows = torch.zeros((1, SPECS[curve].AF), dtype=torch.int64,
                           device=mesh.device)
        sc = torch.zeros((1, NLIMBS), dtype=torch.int64, device=mesh.device)
    wins = make_sharded_window_sums(mesh, curve, reduce)(rows, sc)
    return None if wins is None else combine_window_points(wins.cpu(), curve)
