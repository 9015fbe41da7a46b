"""Batched circom Poseidon over BN254 Fr, on the CUDA permutation kernel.

Counterpart of both `infimum_tpu/hash/poseidon.py` (the XLA permutation,
`poseidon_hash_device`, `merkle_level_device`, `poseidon_batch`) and
`infimum_tpu/hash/poseidon_pallas.py` (the Pallas kernel). At the public
functions a state is (t, B, 16) int64 16-bit limbs in Montgomery form
(R = 2^256), the JAX package's layout, so every value equals the
reference's limb for limb.

`poseidon_perm` launches the kernel `csrc/poseidon_perm.cu` for a CUDA
tensor and raises for any other device but the CPU; for a CPU tensor it
runs `poseidon_perm_plain`, the same rounds in plain torch on `FR_CTX` (the
`poseidon_perm_device` algorithm). The round constants and MDS matrix come
from the Grain LFSR (`grain.py`), cached per width and per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..ff.fp import FR_CTX, NLIMBS, limbs_to_words, words_to_limbs
from ..ff.limbs import to_limbs
from .grain import FULL_ROUNDS, MAX_WIDTH, PARTIAL_ROUNDS, poseidon_params


@functools.lru_cache(maxsize=None)
def device_params(t: int):
    """ark (rounds, t, 16), mds (t, t, 16) uint32 Montgomery limbs and the
    (rounds,) full-round mask: the reference's `_device_params(t)`."""
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


_TABLES: dict = {}


def tables(t: int, device, words: bool):
    """(ark, mds) on `device`, cached per width and device: contiguous int32
    words (rounds, t, 8) and (t, t, 8), the kernel's form, when `words`;
    else int64 limbs (rounds, t, 16) and (t, t, 16), the plain version's."""
    key = (t, str(torch.device(device)), words)
    if key not in _TABLES:
        ark, mds, _ = device_params(t)
        pair = [torch.from_numpy(x.astype(np.int64)) for x in (ark, mds)]
        if words:
            pair = [limbs_to_words(x).contiguous() for x in pair]
        _TABLES[key] = tuple(x.to(device) for x in pair)
    return _TABLES[key]


def _check_width(t: int):
    if not 2 <= t <= MAX_WIDTH:
        raise ValueError(f"unsupported poseidon width {t}")


# -- the kernel -----------------------------------------------------------------

def perm_words(words: torch.Tensor) -> torch.Tensor:
    """(t, 8, B) contiguous int32 Montgomery words on a card -> the permuted
    state, same layout: one launch of the kernel."""
    t, nw, b = words.shape
    _check_width(t)
    if (words.device.type != "cuda" or words.dtype != torch.int32
            or nw != 8 or not words.is_contiguous()):
        raise ValueError(f"perm_words: want contiguous int32 (t, 8, B) on a "
                         f"card, got {words.dtype} {tuple(words.shape)} on "
                         f"{words.device}")
    out = torch.empty_like(words)
    if b:
        ark, mds = tables(t, words.device, words=True)
        kernels.KERNELS["poseidon_perm"](words, out, ark, mds, t,
                                         PARTIAL_ROUNDS[t - 2], b)
    return out


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


def poseidon_perm_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on (t, B, 16) Montgomery limbs:
    per round the constants, the S-box (element 0 only in a partial round)
    and the MDS as t^2 products summed over j."""
    t = state.shape[0]
    _check_width(t)
    ark, mds = tables(t, state.device, words=False)
    full = device_params(t)[2]
    s = state
    for r in range(ark.shape[0]):
        s = FR_CTX.add(s, ark[r].unsqueeze(1))
        s = _sbox(s) if full[r] else torch.cat([_sbox(s[:1]), s[1:]])
        prods = FR_CTX.mont_mul(mds.unsqueeze(2), s.unsqueeze(0))
        acc = prods[:, 0]
        for j in range(1, t):
            acc = FR_CTX.add(acc, prods[:, j])
        s = acc
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
