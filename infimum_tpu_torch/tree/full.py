# Copied from infimum_tpu/tree/full.py; the port keeps its own host layers.
"""Dense Merkle tree with padding, for witness/path extraction.

The on-chain side only keeps the amortized frontier (tree/imt.py, mirroring
pallet/src/poll/state.rs); the prover needs full trees to extract inclusion
paths for circuit witnesses (the role maci-core's IncrementalQuinTree plays
for the reference CLI, cli/src/utils.ts:104-126)."""

from __future__ import annotations

from ..hash.poseidon_host import poseidon


class FullTree:
    """Fixed-depth arity-k tree, padded with a zero-leaf cascade."""

    def __init__(self, arity: int, depth: int, zero_leaf: int, leaves=()):
        self.arity = arity
        self.depth = depth
        self.levels: list[list[int]] = [list(leaves)]
        self.zeros = [zero_leaf]
        for _ in range(depth):
            self.zeros.append(poseidon([self.zeros[-1]] * arity))
        cur = self.levels[0]
        for lvl in range(depth):
            pad = (-len(cur)) % arity if cur else arity
            cur = cur + [self.zeros[lvl]] * pad
            self.levels[lvl] = cur
            cur = [
                poseidon(cur[i : i + arity])
                for i in range(0, len(cur), arity)
            ]
            self.levels.append(cur)
        # pad intermediate levels conceptually with zero hashes on demand

    def _node(self, lvl: int, idx: int) -> int:
        level = self.levels[lvl]
        return level[idx] if idx < len(level) else self.zeros[lvl]

    @property
    def root(self) -> int:
        return self._node(self.depth, 0)

    def update(self, index: int, leaf: int):
        """Set leaf `index` and recompute its ancestors (O(arity * depth))."""
        level = self.levels[0]
        if index >= len(level):
            level.extend([self.zeros[0]] * (index + 1 - len(level)))
        level[index] = leaf
        idx = index
        for lvl in range(self.depth):
            parent = idx // self.arity
            base = parent * self.arity
            group = [self._node(lvl, base + j) for j in range(self.arity)]
            plist = self.levels[lvl + 1]
            if parent >= len(plist):
                plist.extend([self.zeros[lvl + 1]] * (parent + 1 - len(plist)))
            plist[parent] = poseidon(group)
            idx = parent

    def path(self, index: int, from_level: int = 0):
        """Siblings + digit indices from `from_level` up to the root.

        `index` is a LEAF index; with from_level > 0 the path starts at the
        leaf's ancestor node on that level. Returns (elements, indices): per
        level, the arity-1 sibling values (in order, excluding the node) and
        the node's digit at that level."""
        elements, indices = [], []
        idx = index // (self.arity ** from_level)
        for lvl in range(from_level, self.depth):
            digit = idx % self.arity
            base = idx - digit
            sibs = [
                self._node(lvl, base + j)
                for j in range(self.arity)
                if j != digit
            ]
            elements.append(sibs)
            indices.append(digit)
            idx //= self.arity
        return elements, indices
