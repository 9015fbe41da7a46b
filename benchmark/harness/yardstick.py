"""The yardstick of the MSM kernels' roofline: the H100's peaks, and the
least work the five MSMs of one proof need, from that proof's inputs alone.

What is counted never depends on the program's window width, digits or
addition formulas:

- Which scalars are live: a witness value that is not zero, on a query
  point that is not infinity. A query point is infinity where its
  variable has no term in the query's matrix (a: A and the public rows
  (x_i, 0, 0); b1, b2: B; l: any private variable with a term anywhere).
  h's m - 1 coefficients are the program's output and are not read: a
  uniformly random element of Fr has 250 bits or more with probability
  about 0.92, and each is counted at H_BITS = 250 bits.
- Additions: the bucket method (Pippenger) at the window width c that
  needs the fewest for these scalars' bit lengths, signed digits
  (2^(c-1) buckets): in window w, one addition for each scalar with bits
  above w c, and 2^(c-1) - 2 more for the running sum; c doublings and an
  addition to join each further window. Each doubling is counted as an
  addition.
- Products per addition: the fewest Fq products of a published formula,
  affine addition with the inversion shared over a batch (Montgomery's
  trick: 3 products an element), lambda, lambda^2 and the new y: 5 products
  and 1 square in G1. In G2 over Fq2, with an Fq2 product at 3 Fq products
  (Karatsuba) and an Fq2 square at 2: 17 Fq products.
- 32-bit multiplies per product: an 8-limb Montgomery product (CIOS)
  takes 64 limb products, each a low and a high half, and 8 x (1 + 16)
  for the reduction: 264; a square shares its cross products: 36 limb
  products, 208.
- Bytes: each live point (64 bytes in G1, 128 in G2, affine) and its
  32-byte scalar read once.

So no implementation that keeps to the bucket method and to 32-bit
schoolbook products does less. A product by Karatsuba over limbs or a
method other than buckets (precomputed multiples of the fixed points)
would fall outside this count.
"""

from __future__ import annotations

from collections import Counter

# H100 SXM5 (NVIDIA H100 80GB HBM3): 132 SMs at the 1,980 MHz maximum SM
# clock, 64 32-bit integer multiplies a clock an SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0);
# HBM3 3.35 TB/s (NVIDIA's data sheet). At the card's 700 W limit.
H100_SMS = 132
H100_SM_HZ = 1.98e9
INT32_MULS_PER_CLOCK_SM = 64
INT32_MUL_PER_S = H100_SMS * H100_SM_HZ * INT32_MULS_PER_CLOCK_SM
HBM_BYTES_PER_S = 3.35e12

MULS_PER_PRODUCT = 2 * 64 + 8 * (1 + 16)      # 264
MULS_PER_SQUARE = 2 * 36 + 8 * (1 + 16)       # 208
MULS_PER_ADD = {"g1": 5 * MULS_PER_PRODUCT + MULS_PER_SQUARE,
                "g2": 17 * MULS_PER_PRODUCT}
POINT_BYTES = {"g1": 64, "g2": 128}
SCALAR_BYTES = 32
H_BITS = 250
MAX_WINDOW = 24


def bucket_adds(bits: Counter) -> int:
    """Fewest additions of the bucket method over scalars whose bit
    lengths are counted in `bits` ({bit length: scalars}), at its best
    window width."""
    if not bits:
        return 0
    top = max(bits)
    above = [0] * (top + 2)          # above[b]: scalars with more than b bits
    for b in range(top, -1, -1):
        above[b] = above[b + 1] + bits.get(b + 1, 0)
    best = None
    for c in range(1, MAX_WINDOW + 1):
        nwin = -(-top // c)
        adds = (nwin - 1) * (c + 1)
        for w in range(nwin):
            d = above[w * c]
            if d:
                adds += d + (1 << (c - 1)) - 2
        best = adds if best is None else min(best, adds)
    return best


def msm_least_s(curve: str, bits: Counter) -> float:
    """Least seconds of one MSM on the card: the larger of its multiplies
    over the peak rate and its bytes over the memory rate."""
    live = sum(bits.values())
    ops = bucket_adds(bits) * MULS_PER_ADD[curve]
    nbytes = live * (POINT_BYTES[curve] + SCALAR_BYTES)
    return max(ops / INT32_MUL_PER_S, nbytes / HBM_BYTES_PER_S)


def query_supports(cs) -> dict[str, set]:
    """The variables whose query points are not infinity, per query."""
    npub = cs.num_public + 1
    in_a, in_b, anywhere = set(range(npub)), set(), set(range(npub))
    for a, b, c in cs.constraints:
        in_a.update(a.terms)
        in_b.update(b.terms)
        anywhere.update(c.terms)
    anywhere |= in_a | in_b
    return {"a": in_a, "b": in_b,
            "l": {i for i in anywhere if i >= npub}}


def proof_msms(supports: dict, witness: list[int], h_count: int):
    """[(curve, Counter of live scalars' bit lengths)] of one proof's five
    MSMs: a, b1, l and h over G1, b2 over G2."""
    def bits(support):
        return Counter(witness[i].bit_length() for i in support
                       if witness[i])
    a, b, l_ = bits(supports["a"]), bits(supports["b"]), bits(supports["l"])
    return [("g1", a), ("g1", b), ("g1", l_),
            ("g1", Counter({H_BITS: h_count})), ("g2", b)]


def proof_least_s(msms) -> float:
    """Least seconds of one proof's MSMs, one after another."""
    return sum(msm_least_s(curve, bits) for curve, bits in msms)
