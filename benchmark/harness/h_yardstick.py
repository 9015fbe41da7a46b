"""The yardstick of the H stage's roofline: the least time one proof's H
stage needs on the H100, from two counts alone, the domain n and the row
table's terms over a, b and c, as the program counts them on its span
`prove.h_dispatch`.

What is counted is the stage's arithmetic, whatever kernels do it and
however they are launched:

- Fr products: one a term of the row evaluation (coefficient times
  witness value); each radix-2 transform's butterflies whose twiddle is
  not 1 (stage s of n values has n/2 butterflies, n/2^s of them with
  twiddle 1); then the values' multiplies: the iNTT of a, b and c times
  1/n, the coset NTT's input times the coset powers, and the coset iNTT of
  a.b - c with the product a.b and its output times 1/(nZ) and the
  inverse coset powers. Each product at the MSM yardstick's 264 32-bit
  multiplies (an 8-limb CIOS Montgomery product).
- Bytes: each term's column (4) and coefficient (32) read once, the three
  rows written once, each transform's values read and written once with
  its twiddle table and its coset table once. The witness's read is left
  out (the counts do not give its length), so the bound is at most the
  true one's.

So no implementation of the same QAP reduction on the radix-2 domain
(three interpolations, three coset evaluations, one coset interpolation)
does less. At the cells' shapes the products bound it, at 2.5 to 3.3
times the bytes' time.
"""

from __future__ import annotations

from .spans import _inside
from .yardstick import HBM_BYTES_PER_S, INT32_MUL_PER_S, MULS_PER_PRODUCT

VALUE_BYTES = 32
TERM_BYTES = 4 + VALUE_BYTES
SPAN = "prove.h_dispatch"


def transform_products(n: int) -> int:
    """Fr products of one radix-2 transform of n values: its butterflies
    whose twiddle is not 1."""
    return sum(n // 2 - (n >> s) for s in range(1, n.bit_length()))


def h_products(n: int, terms: int) -> int:
    """Fr products of one H stage at domain n over `terms` row terms."""
    t = transform_products(n)
    return (terms
            + 3 * (t + n)              # iNTT of a, b, c; x 1/n
            + 3 * (t + n)              # coset NTT; input x coset powers
            + t + 3 * n)               # a.b - c, coset iNTT; x 1/(nZ), x g^-i


def h_bytes(n: int, terms: int) -> int:
    """Bytes of one H stage: the terms, the rows out, and each transform's
    values in and out with its tables."""
    rows = terms * TERM_BYTES + 3 * n * VALUE_BYTES
    transforms = ((3 * n + 3 * n + (n - 1))              # iNTT
                  + (3 * n + 3 * n + (n - 1) + n)        # coset NTT
                  + (3 * n + n + (n - 1) + n))           # coset iNTT
    return rows + transforms * VALUE_BYTES


def h_least_s(n: int, terms: int) -> float:
    """Least seconds of one H stage on the card: the larger of its
    multiplies over the peak rate and its bytes over the memory rate."""
    return max(h_products(n, terms) * MULS_PER_PRODUCT / INT32_MUL_PER_S,
               h_bytes(n, terms) / HBM_BYTES_PER_S)


def window_least_s(start: float, end: float) -> float | None:
    """Least seconds of the H stages whose `prove.h_dispatch` spans lie in
    [start, end] (host clock), from their counters; None where the program
    keeps no span log, its ring dropped a span there, no such span lies
    there, or one carries no counters (a program without them)."""
    counts = [getattr(s, "counts", None) for s in _inside(start, end) or ()
              if s.name == SPAN]
    if not counts or not all(c and "domain" in c and "terms" in c
                             for c in counts):
        return None
    return sum(h_least_s(c["domain"], c["terms"]) for c in counts)
