"""Batched circom Poseidon over BN254 Fr, on the CUDA permutation kernel.

Counterpart of both `infimum_tpu/hash/poseidon.py` (the XLA permutation,
`poseidon_hash_device`, `merkle_level_device`, `poseidon_batch`) and
`infimum_tpu/hash/poseidon_pallas.py` (the Pallas kernel). At the public
functions a state is (t, B, 16) int64 16-bit limbs in Montgomery form
(R = 2^256), the JAX package's layout, so every value equals the
reference's limb for limb.

`poseidon_perm` launches the kernel `csrc/poseidon_perm.cu` for a CUDA
tensor and raises for any other device but the CPU; for a CPU tensor it
runs `poseidon_perm_plain`, the same rounds in plain torch on `FR_CTX`.
Both compute the optimized form of `poseidon_sparse.py` (folded constants,
sparse partial rounds), whose tables follow from the Grain parameters
(`grain.py`) and are cached per width and per device. The reference's
dense form stays as `poseidon_perm_dense_plain`, for the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..ff.fp import (
    FR_CTX, NLIMBS, device_key, limbs_to_words, words_to_limbs,
)
from ..ff.limbs import to_limbs
from .grain import FULL_ROUNDS, MAX_WIDTH, PARTIAL_ROUNDS, poseidon_params
from .poseidon_sparse import sparse_params


@functools.lru_cache(maxsize=None)
def device_params(t: int):
    """ark (rounds, t, 16), mds (t, t, 16) uint32 Montgomery limbs and the
    (rounds,) full-round mask: the reference's `_device_params(t)`, the
    tables of the dense form."""
    ark, mds = poseidon_params(t)
    r_p = PARTIAL_ROUNDS[t - 2]
    rounds = FULL_ROUNDS + r_p
    half = FULL_ROUNDS // 2
    ark_arr = np.array([[to_limbs(FR_CTX.to_mont_int(ark[r * t + i]))
                         for i in range(t)] for r in range(rounds)],
                       dtype=np.uint32)
    mds_arr = np.array([[to_limbs(FR_CTX.to_mont_int(mds[i][j]))
                         for j in range(t)] for i in range(t)],
                       dtype=np.uint32)
    full_mask = np.array([r < half or r >= half + r_p
                          for r in range(rounds)], dtype=np.bool_)
    return ark_arr, mds_arr, full_mask


def _mont_limbs(values, device) -> torch.Tensor:
    """Nested lists of ints -> int64 Montgomery limbs (..., 16)."""
    arr = np.asarray(values, dtype=object)
    flat = FR_CTX.encode(arr.reshape(-1).tolist(), device)
    return flat.reshape(*arr.shape, NLIMBS)


_TABLES: dict = {}


def tables(t: int, device, words: bool):
    """The optimized permutation's tables (`poseidon_sparse.sparse_params`)
    on `device`, cached per width and device: (C, M, P, S) of shapes
    (t R_F + R_P, W), (t, t, W), (t, t, W) and (R_P, 2t - 1, W), Montgomery
    form, each contiguous: W = 8 int32 words, the kernel's form, when
    `words`; else W = 16 int64 limbs, the plain version's."""
    key = (t, device_key(device), words)
    if key not in _TABLES:
        sp = sparse_params(t)
        out = [_mont_limbs(x, "cpu") for x in (sp.c, sp.m, sp.p, sp.s)]
        if words:
            out = [limbs_to_words(x).contiguous() for x in out]
        _TABLES[key] = tuple(x.to(device) for x in out)
    return _TABLES[key]


def dense_tables(t: int, device):
    """(ark, mds) of the dense form as int64 Montgomery limbs on `device`:
    (rounds, t, 16) and (t, t, 16)."""
    key = (t, device_key(device), "dense")
    if key not in _TABLES:
        ark, mds, _ = device_params(t)
        _TABLES[key] = tuple(torch.from_numpy(x.astype(np.int64)).to(device)
                             for x in (ark, mds))
    return _TABLES[key]


def _check_width(t: int):
    if not 2 <= t <= MAX_WIDTH:
        raise ValueError(f"unsupported poseidon width {t}")


# -- the kernel -----------------------------------------------------------------

def perm_words(words: torch.Tensor, variant: int | None = None
               ) -> torch.Tensor:
    """(t, 8, B) contiguous int32 Montgomery words on a card -> the permuted
    state, same layout: one launch of the kernel. `variant` launches one of
    the kernel's measured variants at t = 6 instead (`VARIANTS`)."""
    t, nw, b = words.shape
    _check_width(t)
    if (words.device.type != "cuda" or words.dtype != torch.int32
            or nw != 8 or not words.is_contiguous()):
        raise ValueError(f"perm_words: want contiguous int32 (t, 8, B) on a "
                         f"card, got {words.dtype} {tuple(words.shape)} on "
                         f"{words.device}")
    if variant is not None and (t != 6 or variant not in VARIANTS.values()):
        raise ValueError(f"no kernel variant {variant} at width {t}")
    out = torch.empty_like(words)
    if b:
        tabs = tables(t, words.device, words=True)
        args = (words, out, *tabs, t, PARTIAL_ROUNDS[t - 2], b)
        if variant is None:
            kernels.KERNELS["poseidon_perm"](*args)
        else:
            kernels.KERNELS["poseidon_perm_variant"](*args, variant)
    return out


# The kernel's variants at t = 6, for measurement (bit 0: the product out
# of line; bit 1: the tables staged in shared memory; bit 2: each matrix
# row as t reduced products instead of one sum reduced once).
VARIANTS = {"inline, __ldg": 0, "out of line, __ldg": 1,
            "inline, shared": 2, "out of line, shared": 3,
            "out of line, shared, rows as t products": 7}


def poseidon_perm(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of (t, B, 16) Montgomery limbs."""
    if state.device.type == "cuda":
        words = limbs_to_words(state).transpose(1, 2).contiguous()
        return words_to_limbs(perm_words(words).transpose(1, 2))
    if state.device.type != "cpu":
        raise ValueError(f"no poseidon_perm kernel for {state.device}")
    return poseidon_perm_plain(state)


# -- the plain version ----------------------------------------------------------

def _sbox(x):
    x2 = FR_CTX.mont_sqr(x)
    x4 = FR_CTX.mont_sqr(x2)
    return FR_CTX.mont_mul(x4, x)


def _mix(mat, s):
    """mat * s: (n, t, 16) by (t, B, 16) -> (n, B, 16), each row's t
    products summed."""
    prods = FR_CTX.mont_mul(mat.unsqueeze(2), s.unsqueeze(0))
    acc = prods[:, 0]
    for j in range(1, s.shape[0]):
        acc = FR_CTX.add(acc, prods[:, j])
    return acc


def poseidon_perm_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on (t, B, 16) Montgomery limbs:
    the optimized permutation of `poseidon_sparse`, its rounds and products
    in the kernel's order (the kernel reduces each row's sum once; the
    values are the same). A partial round is one S-box and its constant on
    element 0, then the sparse mix: the new element 0 is the first row
    times the state, every other element adds the first column's entry
    times element 0."""
    t = state.shape[0]
    _check_width(t)
    c, m, p, sparse = tables(t, state.device, words=False)
    half = FULL_ROUNDS // 2
    s = FR_CTX.add(state, c[:t].unsqueeze(1))
    off = t
    for r in range(FULL_ROUNDS):
        s = _sbox(s)
        if r < FULL_ROUNDS - 1:
            s = FR_CTX.add(s, c[off:off + t].unsqueeze(1))
            off += t
        s = _mix(p if r == half - 1 else m, s)
        if r != half - 1:
            continue
        for j in range(sparse.shape[0]):
            s0 = FR_CTX.add(_sbox(s[0]), c[off + j])
            first = _mix(sparse[j, :t].unsqueeze(0),
                         torch.cat([s0[None], s[1:]]))
            rest = FR_CTX.add(s[1:], FR_CTX.mont_mul(
                sparse[j, t:].unsqueeze(1), s0))
            s = torch.cat([first, rest])
        off += sparse.shape[0]
    return s


def poseidon_perm_dense_plain(state: torch.Tensor) -> torch.Tensor:
    """The reference's dense form in plain torch, on (t, B, 16) Montgomery
    limbs: per round the constants, the S-box (element 0 only in a partial
    round) and the full MDS product. It holds the optimized tables against
    the reference's algorithm in the tests."""
    t = state.shape[0]
    _check_width(t)
    ark, mds = dense_tables(t, state.device)
    full = device_params(t)[2]
    s = state
    for r in range(ark.shape[0]):
        s = FR_CTX.add(s, ark[r].unsqueeze(1))
        s = _sbox(s) if full[r] else torch.cat([_sbox(s[:1]), s[1:]])
        s = _mix(mds, s)
    return s


# -- hashing ----------------------------------------------------------------------

def poseidon_hash(inputs: torch.Tensor) -> torch.Tensor:
    """Batched circom Poseidon: (n, B, 16) Montgomery limbs -> (B, 16);
    width t = n + 1 with a zero domain tag in front, output element 0."""
    zero = torch.zeros((1, *inputs.shape[1:]), dtype=inputs.dtype,
                       device=inputs.device)
    return poseidon_perm(torch.cat([zero, inputs]))[0]


def merkle_level(nodes: torch.Tensor, arity: int) -> torch.Tensor:
    """One Merkle level: (K * arity, 16) Montgomery nodes -> (K, 16)
    parents, each the hash of `arity` consecutive nodes."""
    k = nodes.shape[0] // arity
    return poseidon_hash(nodes.reshape(k, arity, NLIMBS).transpose(0, 1))


def poseidon_batch(columns: list[list[int]], device="cuda") -> list[int]:
    """Hash B independent n-input tuples, columns[i] holding the i-th input
    of every tuple: ints in, ints out, hashed on `device`."""
    enc = torch.stack([FR_CTX.encode(col, device) for col in columns])
    return FR_CTX.decode(poseidon_hash(enc))
