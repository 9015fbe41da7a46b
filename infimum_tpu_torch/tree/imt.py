# Copied from infimum_tpu/tree/imt.py; the port keeps its own host layers.
"""Amortized incremental Merkle tree (host control, batched device hashing optional).

Semantics mirror the reference on-chain tree exactly
(reference: pallet/src/poll/state.rs:176-281):

  - `insert` pushes a (depth 0, leaf) pair and greedily collapses any full
    arity-sized group of equal-depth rightmost nodes into their parent;
  - `merge` pads the rightmost equal-depth group with zero-subtree hashes and
    collapses upward; with `to_depth=True` it continues to the fixed full depth
    (the circuits require a compile-time-known tree height), otherwise it stops
    at the first single root.

Values are python ints mod r; hashing is circom Poseidon of the node arity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hash.poseidon_host import poseidon
from .zeros import merkle_zeros


class MerkleTreeError(Exception):
    TREE_ALREADY_FULL = 1
    TREE_ALREADY_MERGED = 2
    HASH_FAILED = 3
    MERGE_FAILED = 4

    def __init__(self, code: int):
        self.code = code
        super().__init__(f"merkle tree error {code}")


@dataclass
class AmortizedIMT:
    arity: int
    full_depth: int
    depth: int = 0
    count: int = 0
    hashes: list[tuple[int, int]] = field(default_factory=list)
    root: int | None = None

    @classmethod
    def new(cls, arity: int, full_depth: int, zero_seed: bool = False) -> "AmortizedIMT":
        """zero_seed pre-inserts (0, zeros[0]) without bumping count — the
        registration tree's blank state leaf (reference: poll/state.rs:48-52)."""
        t = cls(arity=arity, full_depth=full_depth)
        if zero_seed:
            t.hashes.append((0, merkle_zeros(arity)[0]))
        return t

    def insert(self, leaf: int) -> int:
        if self.root is not None:
            raise MerkleTreeError(MerkleTreeError.TREE_ALREADY_FULL)
        self.count += 1
        self.hashes.append((0, leaf))

        while len(self.hashes) >= self.arity:
            group = self.hashes[-self.arity:]
            depth = group[0][0]
            if all(d == depth for d, _ in group):
                parent = poseidon([h for _, h in group])
                del self.hashes[-self.arity:]
                self.hashes.append((depth + 1, parent))
                if self.depth < depth + 1:
                    self.depth = depth + 1
            else:
                break

        if len(self.hashes) == 1 and self.hashes[0][0] == self.full_depth:
            self.root = self.hashes[0][1]
            self.hashes.clear()
        return self.count

    def merge(self, to_depth: bool) -> None:
        if self.root is not None:
            raise MerkleTreeError(MerkleTreeError.TREE_ALREADY_MERGED)
        zeros = merkle_zeros(self.arity)
        while self.hashes:
            depth = self.hashes[-1][0]
            if len(self.hashes) == 1 and (not to_depth or depth == self.full_depth):
                break
            # rightmost run of equal-depth nodes, restored to insertion order
            group = []
            for d, h in reversed(self.hashes):
                if d != depth:
                    break
                group.append(h)
            group.reverse()
            size = len(group)
            if self.arity >= size:
                group.extend([zeros[depth]] * (self.arity - size))
            parent = poseidon(group)
            del self.hashes[-size:]
            self.hashes.append((depth + 1, parent))
            # DELIBERATE fix over the reference: its merge never updates the
            # `depth` field (state.rs:230-281), yet publishes it as the
            # process circuit's actualStateTreeDepth public input
            # (provider.rs:182) — so any reference poll whose merge pads the
            # tree taller than the deepest full subtree (> 3 registrations)
            # derives a public input inconsistent with its own merged root
            # and can never be proven. Tracking the true depth keeps the
            # public input consistent; values coincide with the reference
            # for every fixture scenario (<= 3 registrations).
            if depth + 1 > self.depth:
                self.depth = depth + 1

        if len(self.hashes) == 1:
            self.root = self.hashes[0][1]
            self.hashes.clear()
