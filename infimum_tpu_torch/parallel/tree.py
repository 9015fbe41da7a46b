"""Merkle tree build through the Poseidon kernel, on one card or sharded
over a process group.

Counterpart of `infimum_tpu/parallel/tree.py`. `build_tree` hashes an
(arity^depth, 16) leaf tensor up to its root on one device, one
`merkle_level` per level, and `tree_root` is the host convenience around
it (int leaves padded to arity^depth, int root).

The mesh form shards the leaves over the ranks of a group
(`parallel/distributed.py`): `make_tree_builder` has each rank build its
subtree through the Poseidon kernel on its card, all_gathers the D
subtree roots, and finishes the top j levels on every rank. The group
size must be arity^j (binary trees shard over 2^j ranks, quinary over
5^j), so rank boundaries fall on node groups at every level.
`sharded_tree_root` is its host convenience.

Padding follows the fixed-depth trees of a poll: `zero` fills the leaf
slots, so every empty subtree hashes to the zero table of its level.
`zero=0` matches the reference's `sharded_tree_root`; the poll's trees pad
with `tree.zeros.merkle_zeros(arity)[0]`, as their `merge(to_depth=True)`
does.
"""

from __future__ import annotations

import math

import torch

from ..ff.fp import FR_CTX, limbs_to_words, words_to_limbs
from ..hash.poseidon import merkle_level
from ..hash.poseidon_host import poseidon
from . import distributed as D


def build_tree(leaves: torch.Tensor, arity: int, depth: int) -> torch.Tensor:
    """(arity^depth, 16) Montgomery leaves -> (16,) Montgomery root."""
    if leaves.shape[0] != arity ** depth:
        raise ValueError(f"{leaves.shape[0]} leaves for a tree of "
                         f"{arity}^{depth}")
    nodes = leaves
    for _ in range(depth):
        nodes = merkle_level(nodes, arity)
    return nodes[0]


def tree_root(arity: int, depth: int, leaves: list[int], zero: int = 0,
              device="cuda") -> int:
    """Root of the fixed-depth tree over int `leaves`, the remaining slots
    filled with `zero`, built on `device`."""
    n_full = arity ** depth
    if len(leaves) > n_full:
        raise ValueError("too many leaves for depth")
    padded = list(leaves) + [zero] * (n_full - len(leaves))
    root = build_tree(FR_CTX.encode(padded, device), arity, depth)
    return FR_CTX.decode(root)[0]


def _axis_levels(arity: int, axis_size: int) -> int:
    """j with arity^j == axis_size (the group/arity contract)."""
    j = round(math.log(axis_size, arity))
    if arity ** j != axis_size:
        raise ValueError(
            f"group size {axis_size} is not a power of arity {arity}")
    return j


def make_tree_builder(mesh: D.ProvingMesh, arity: int, depth: int):
    """Returns fn: this rank's (arity^depth / D, 16) Montgomery leaves ->
    the whole tree's (16,) Montgomery root, on every rank."""
    j = _axis_levels(arity, mesh.world)
    if depth < j:
        raise ValueError(f"depth {depth} < log_arity(ranks) {j}")

    def build(leaves: torch.Tensor) -> torch.Tensor:
        sub = build_tree(leaves, arity, depth - j)
        return build_tree(words_to_limbs(D.all_gather(limbs_to_words(sub),
                                                      mesh)), arity, j)

    return build


def sharded_tree_root(mesh: D.ProvingMesh, arity: int, depth: int,
                      leaves: list[int], zero: int = 0) -> int:
    """Root of the fixed-depth tree over int `leaves`, the remaining slots
    filled with `zero`, built over the group: this rank encodes and hashes
    its share of the leaves on its device."""
    n_full = arity ** depth
    if len(leaves) > n_full:
        raise ValueError("too many leaves for depth")
    build = make_tree_builder(mesh, arity, depth)
    padded = list(leaves) + [zero] * (n_full - len(leaves))
    mine = FR_CTX.encode(padded[D.host_shard(n_full, mesh)], mesh.device)
    return FR_CTX.decode(build(mine))[0]


def host_tree_root(arity: int, depth: int, leaves: list[int]) -> int:
    """Reference root (zero-leaf = 0 cascade), for cross-checks."""
    zeros = [0]
    for _ in range(depth):
        zeros.append(poseidon([zeros[-1]] * arity))
    nodes = list(leaves)
    for lvl in range(depth):
        pad = (-len(nodes)) % arity if nodes else arity
        nodes = nodes + [zeros[lvl]] * pad
        nodes = [poseidon(nodes[i:i + arity])
                 for i in range(0, len(nodes), arity)]
    return nodes[0] if nodes else zeros[depth]
