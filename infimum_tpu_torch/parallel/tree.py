"""Merkle tree build on one device, level by level through the Poseidon
kernel.

Counterpart of `infimum_tpu/parallel/tree.py` `make_tree_builder` /
`sharded_tree_root` on a one-device mesh: `build_tree` hashes an
(arity^depth, 16) leaf tensor up to its root with one `merkle_level` per
level, and `tree_root` is the host convenience around it (int leaves
padded to arity^depth, int root). The mesh form, with the leaves sharded
over several cards, their subtree roots gathered and the top of the tree
finished on each, comes with the port of `parallel/` over
`torch.distributed`.

Padding follows the fixed-depth trees of a poll: `zero` fills the leaf
slots, so every empty subtree hashes to the zero table of its level.
`zero=0` matches `sharded_tree_root`; the poll's trees pad with
`tree.zeros.merkle_zeros(arity)[0]`, as their `merge(to_depth=True)` does.
"""

from __future__ import annotations

import torch

from ..ff.fp import FR_CTX
from ..hash.poseidon import merkle_level
from ..hash.poseidon_host import poseidon


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
