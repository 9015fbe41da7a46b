"""Sharded NTT over BN254 Fr across a process group (four-step algorithm).

Counterpart of `infimum_tpu/parallel/ntt.py`, with its layout contract and
its split, so that each rank's slab equals the reference's shard limb for
limb. N = N2 * N1, D ranks:

  natural form   a2d[j2, j1] = a[j2 * N1 + j1]: rank r holds the columns
                 [r N1/D, (r+1) N1/D), an (N2, N1/D, 16) slab
  k-form         out[k2, k1] = NTT(a)[k1 * N2 + k2]: rank r holds the rows
                 [r N2/D, (r+1) N2/D), an (N2/D, N1, 16) slab

`make_ntt_sharded` maps natural to k-form: a local NTT of length N2 over
axis 0, the twiddle w^(j1 k2), one all_to_all (split axis 0, concat axis
1) and a local NTT of length N1 over axis 1. `make_intt_sharded` is its
exact inverse. Between the functions' edges the slab stays in 32-bit
Montgomery words: the local transforms are `ntt/ntt.py` `ntt_words` (the
tile and pass kernels on a card), the twiddle product is `pointwise` (the
pointwise kernel), and the all_to_all moves the words. Each rank builds
only its own twiddle slab, on its device, once, and keeps it as words.

Values at the functions' edges are (..., 16) int64 Montgomery limbs
(`ff/fp.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff.bn254 import fr_inv
from ..ff.fp import FR_CTX, NLIMBS, device_key, limbs_to_words, words_to_limbs
from ..ntt.ntt import _root_of_unity, fr_const, ntt_words, pointwise
from . import distributed as D


def _split(logn: int, ndev: int) -> tuple[int, int]:
    """(logn2, logn1): axis 0 of 2^logn2, axis 1 of 2^logn1, with N1 and N2
    both divisible by the group (the reference's rule)."""
    logd = ndev.bit_length() - 1
    if 1 << logd != ndev:
        raise ValueError(f"the group size {ndev} is not a power of two")
    logn1 = max(logn // 2, logd)
    logn2 = logn - logn1
    if logn2 < logd:
        raise ValueError(f"domain 2^{logn} too small for {ndev} ranks")
    return logn2, logn1


def _geometric(x: torch.Tensor, m: int) -> torch.Tensor:
    """(B, 16) Montgomery x -> (B, m, 16) powers x^0 .. x^(m-1), m a power
    of two, by doubling the run of powers log2(m) times."""
    out = FR_CTX.one((x.shape[0], 1), x.device).contiguous()
    step = x
    while out.shape[1] < m:
        out = torch.cat([out, FR_CTX.mont_mul(out, step.unsqueeze(1))], 1)
        step = FR_CTX.mont_sqr(step)
    return out


def _twiddle_slab(logn2: int, logn1: int, invert: bool, j0: int, width: int,
                  device: str) -> torch.Tensor:
    """w^(j1 k2) (w^-1 with `invert`) for every k2 and the columns j1 in
    [j0, j0 + width): (N2, width, 16) Montgomery limbs."""
    w = _root_of_unity(1 << (logn2 + logn1))
    if invert:
        w = fr_inv(w)
    rows = _geometric(FR_CTX.encode([w], device), 1 << logn2)[0]  # w^k2
    first = FR_CTX.mont_pow(rows, j0)                              # w^(k2 j0)
    return FR_CTX.mont_mul(_geometric(rows, width), first.unsqueeze(1))


@functools.lru_cache(maxsize=None)
def _twiddle_words(logn2: int, logn1: int, invert: bool, j0: int, width: int,
                   device: str) -> torch.Tensor:
    """`_twiddle_slab` as Montgomery words, column-major as the axis-0
    transform leaves its output: (width, N2, 8), entry [j1, k2]."""
    slab = _twiddle_slab(logn2, logn1, invert, j0, width, device)
    return limbs_to_words(slab.transpose(0, 1)).contiguous()


def _twiddles(mesh: D.ProvingMesh, logn2: int, logn1: int, invert: bool):
    cols = D.host_shard(1 << logn1, mesh)
    return _twiddle_words(logn2, logn1, invert, cols.start,
                          cols.stop - cols.start, device_key(mesh.device))


def _ntt(x: torch.Tensor, logn: int, invert: bool) -> torch.Tensor:
    """The transform over dim -2 of (..., 2^logn, 8) words, the inverse's
    1/n folded in, as `ntt/ntt.py` `ntt` does on limbs."""
    post_c = fr_const(fr_inv(1 << logn), device_key(x.device)) \
        if invert else None
    return ntt_words(x, logn, invert, post_c=post_c)


def make_ntt_sharded(mesh: D.ProvingMesh, logn: int, invert: bool = False):
    """Returns (fn, logn2, logn1): fn maps this rank's natural-form column
    slab (N2, N1/D, 16) to its k-form row slab (N2/D, N1, 16)."""
    logn2, logn1 = _split(logn, mesh.world)
    tw = _twiddles(mesh, logn2, logn1, invert)

    def fn(a_l):
        n2, n1l = a_l.shape[:2]
        # axis 0 as the transform's axis: (N1/D, N2, 8), then the twiddle
        b = limbs_to_words(a_l.transpose(0, 1)).contiguous()
        c = pointwise(_ntt(b, logn2, invert), tw)
        # block i of the result is rank i's columns of my rows
        got = D.all_to_all(c.transpose(0, 1).contiguous(), mesh)
        x = got.reshape(mesh.world, n2 // mesh.world, n1l, NLIMBS // 2) \
               .transpose(0, 1).reshape(n2 // mesh.world, -1, NLIMBS // 2)
        return words_to_limbs(_ntt(x, logn1, invert))

    return fn, logn2, logn1


def make_intt_sharded(mesh: D.ProvingMesh, logn: int):
    """Returns fn mapping this rank's k-form row slab (N2/D, N1, 16) back to
    its natural-form column slab (N2, N1/D, 16): the step-by-step inverse
    of make_ntt_sharded(invert=False)."""
    logn2, logn1 = _split(logn, mesh.world)
    tw_inv = _twiddles(mesh, logn2, logn1, True)

    def fn(d_l):
        n2l, n1 = d_l.shape[:2]
        x = _ntt(limbs_to_words(d_l), logn1, True)
        # block i goes to rank i: its columns of my rows, made contiguous
        blocks = x.reshape(n2l, mesh.world, n1 // mesh.world, NLIMBS // 2) \
                  .transpose(0, 1).reshape(-1, n1 // mesh.world, NLIMBS // 2)
        c = D.all_to_all(blocks, mesh)                  # (N2, N1/D, 8)
        b = pointwise(c.transpose(0, 1).contiguous(), tw_inv)
        return words_to_limbs(_ntt(b, logn2, True).transpose(0, 1))

    return fn


# -- host-level wrappers (tests, the smoke) ------------------------------------------

def column_slab(values: list[int], mesh: D.ProvingMesh, logn2: int,
                logn1: int) -> torch.Tensor:
    """This rank's natural-form column slab of int `values`, encoded on its
    device."""
    cols = np.asarray(values, dtype=object).reshape(1 << logn2, 1 << logn1)[
        :, D.host_shard(1 << logn1, mesh)]
    return FR_CTX.encode(cols.reshape(-1).tolist(), mesh.device).reshape(
        1 << logn2, -1, NLIMBS)


def _gather(slab: torch.Tensor, mesh: D.ProvingMesh, dim: int):
    """Every rank's slab, concatenated along `dim` (0 or 1), as limbs."""
    parts = D.all_gather(limbs_to_words(slab), mesh)
    return words_to_limbs(torch.cat(parts.unbind(0), dim))


def ntt_sharded(values: list[int], mesh: D.ProvingMesh) -> list[int]:
    """In-order NTT of python ints through the sharded transform; every
    rank returns the whole result."""
    n = len(values)
    logn = n.bit_length() - 1
    if 1 << logn != n:
        raise ValueError(f"length {n} is not a power of two")
    fn, logn2, logn1 = make_ntt_sharded(mesh, logn)
    kform = _gather(fn(column_slab(values, mesh, logn2, logn1)), mesh, 0)
    return FR_CTX.decode(kform.transpose(0, 1))         # out[k1 N2 + k2]


def intt_roundtrip_sharded(values: list[int],
                           mesh: D.ProvingMesh) -> list[int]:
    """NTT then iNTT through the sharded transforms, back to in-order
    ints on every rank."""
    logn = len(values).bit_length() - 1
    fwd, logn2, logn1 = make_ntt_sharded(mesh, logn)
    inv = make_intt_sharded(mesh, logn)
    out = inv(fwd(column_slab(values, mesh, logn2, logn1)))
    return FR_CTX.decode(_gather(out, mesh, 1))
