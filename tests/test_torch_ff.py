"""Port field layer (infimum_tpu_torch.ff) against the reference FpCtx / Fq2Ctx.

Inputs come from a numpy seed and include 0, 1, p-1 and limb-carry edges;
the same limbs go through the JAX op and the torch op, and every result
must be equal limb for limb (integer arithmetic: no tolerance)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infimum_tpu.ff.fp import FQ_CTX as REF_FQ, FR_CTX as REF_FR
from infimum_tpu.ff.fq2 import FQ2_CTX as REF_FQ2
from infimum_tpu_torch.ff.fp import FQ_CTX, FR_CTX, to_tensor
from infimum_tpu_torch.ff.fq2 import FQ2_CTX

torch.set_num_threads(1)  # the suite runs in parallel worker processes

CTXS = {"fr": (REF_FR, FR_CTX), "fq": (REF_FQ, FQ_CTX)}


def _rand(seed, n, mod):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % mod
            for row in words]


def _edges(mod):
    return [0, 1, 2, mod - 1, mod - 2, (1 << 16) - 1, 1 << 16,
            (1 << 255) % mod, ((1 << 256) - 1) % mod, mod >> 1,
            sum(0xFFFF << (32 * i) for i in range(8)) % mod]


def _pair(name, seed):
    ref, _ = CTXS[name]
    mod = ref.modulus
    xs = _edges(mod) + _rand(seed, 24, mod)
    ys = list(reversed(_edges(mod))) + _rand(seed + 1, 24, mod)
    return ref.encode(xs), ref.encode(ys)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_reference(name, op):
    ref, ctx = CTXS[name]
    a, b = _pair(name, 11)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(ctx, op)(to_tensor(a, "cpu"), to_tensor(b, "cpu"))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont", "mont_sqr"])
def test_unary_ops_match_reference(name, op):
    ref, ctx = CTXS[name]
    a, _ = _pair(name, 23)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a)))
    got = getattr(ctx, op)(to_tensor(a, "cpu"))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_encode_decode_and_inverse(name):
    ref, ctx = CTXS[name]
    mod = ref.modulus
    xs = [1, 2, mod - 1, mod - 2] + _rand(5, 12, mod)
    enc = ctx.encode(xs)
    assert np.array_equal(enc.numpy(), ref.encode(xs).astype(np.int64))
    assert ctx.decode(enc) == xs
    inv = ctx.mont_inv(enc)
    assert ctx.decode(inv) == [pow(x, -1, mod) for x in xs]


def _fq2_pair(seed):
    mod = REF_FQ.modulus
    xs = _edges(mod) + _rand(seed, 21, mod)
    ys = _rand(seed + 7, len(xs), mod)
    a = REF_FQ.encode(xs).reshape(-1, 2, 16)
    b = REF_FQ.encode(ys).reshape(-1, 2, 16)
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_fq2_binary_ops_match_reference(op):
    a, b = _fq2_pair(3)
    want = np.asarray(getattr(REF_FQ2, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(FQ2_CTX, op)(to_tensor(a, "cpu"), to_tensor(b, "cpu"))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("op", ["neg", "mont_sqr"])
def test_fq2_unary_ops_match_reference(op):
    a, _ = _fq2_pair(9)
    want = np.asarray(getattr(REF_FQ2, op)(jnp.asarray(a)))
    got = getattr(FQ2_CTX, op)(to_tensor(a, "cpu"))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_ops_broadcast_over_leading_dims():
    a, b = _pair("fq", 41)
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    flat = FQ_CTX.mont_mul(ta, tb)
    batched = FQ_CTX.mont_mul(ta.reshape(5, -1, 16)[:, :7],
                              tb.reshape(5, -1, 16)[:, :7])
    assert torch.equal(batched, flat.reshape(5, -1, 16)[:, :7])
    const = FQ_CTX.mont_mul(ta, tb[3])
    assert torch.equal(const[3], flat[3])
