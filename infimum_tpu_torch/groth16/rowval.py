"""Sparse R1CS row evaluation over BN254 Fr in plain PyTorch.

Counterpart of `infimum_tpu/groth16/rowval.py`: a|_H, b|_H and c|_H as one
sparse matrix-vector product per matrix.

  1. encode the witness once: (nv, 16) limbs -> Montgomery (mont_mul by R^2);
  2. per term: mont_mul(coeff_mont[k], w_mont[col[k]]), in chunks of terms
     (the process circuit has about 3.9M), to bound the product's memory;
  3. `index_add_` by row: Montgomery values are linear, so limb sums
     accumulate exactly in int64; one carry pass, a fold of the carry-out
     and conditional subtractions give reduced Montgomery rows, the NTT's
     input encoding.
"""

from __future__ import annotations

import torch

from ..ff.bn254 import FR_MOD
from ..ff.fp import FR_CTX, NLIMBS, carry, ints_to_tensor, sub_borrow

P = FR_MOD
TERM_CHUNK = 1 << 18


class SparseRows:
    """Flattened (coeff, col, row) triples of the A/B/C matrices, on one
    device, coefficients in Montgomery form."""

    def __init__(self, rows, num_rows: int, device="cpu"):
        self.num_rows = num_rows
        self.device = device
        self.mats = {}
        for name, idx in (("A", 0), ("B", 1), ("C", 2)):
            coeffs, cols, rids = [], [], []
            for j, triple in enumerate(rows):
                terms = triple[idx].terms
                if len(terms) >= 1 << 16:
                    raise ValueError("row too long for one-limb carry fold")
                coeffs.extend(terms.values())
                cols.extend(terms.keys())
                rids.extend([j] * len(terms))
            std = ints_to_tensor([c % P for c in coeffs], device)
            self.mats[name] = (
                torch.cat([FR_CTX.to_mont(std[i:i + TERM_CHUNK])
                           for i in range(0, len(coeffs), TERM_CHUNK)])
                if coeffs else std,
                torch.tensor(cols, dtype=torch.int64, device=device),
                torch.tensor(rids, dtype=torch.int64, device=device),
            )


def _shift_mont(device):
    """2^256 mod P in Montgomery form: mont_mul(c, this) = c * 2^256 mod P."""
    return FR_CTX.encode([(1 << 256) % P], device)[0]


def _reduce_rows(sums: torch.Tensor) -> torch.Tensor:
    """(m, 16) int64 limb sums (rows of < 2^16 terms) -> reduced mod P."""
    limbs, c = carry(sums.T)               # value = limbs + c * 2^256
    fold = FR_CTX.mont_mul(
        torch.nn.functional.pad(c.unsqueeze(-1), (0, NLIMBS - 1)),
        _shift_mont(sums.device))          # c < 2^16: one limb
    n = FR_CTX.consts(sums.device)[0].unsqueeze(-1)
    for _ in range(5):                     # limbs < 2^256 < 6P
        d, borrow = sub_borrow(limbs, n)
        limbs = torch.where(borrow == 0, d, limbs)
    return FR_CTX.add(limbs.T, fold)


def _eval_mat(coeffs, cols, rids, w_mont, m):
    sums = torch.zeros((m, NLIMBS), dtype=torch.int64, device=w_mont.device)
    for i in range(0, coeffs.shape[0], TERM_CHUNK):
        j = i + TERM_CHUNK
        sums.index_add_(0, rids[i:j],
                        FR_CTX.mont_mul(coeffs[i:j], w_mont[cols[i:j]]))
    return _reduce_rows(sums)


def eval_rows(sp: SparseRows, witness: list[int], m: int):
    """(a, b, c) as (m, 16) reduced Montgomery tensors on sp.device."""
    w_mont = FR_CTX.to_mont(ints_to_tensor([x % P for x in witness],
                                           sp.device))
    return tuple(_eval_mat(*sp.mats[name], w_mont, m) for name in "ABC")
