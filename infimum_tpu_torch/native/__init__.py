# Copied from infimum_tpu/native/__init__.py; the port keeps its own host layers,
# and its own copy of the Groth16 verifier (libinfimum_verify.so, here).
"""ctypes bindings for the native (C++) pallet-core library.

The reference implements its on-chain side natively in Rust (pallet/src/:
Poseidon hasher, amortized Merkle tree, arkworks deserialization, Groth16
verifier). This package binds the equivalent C++ library
(native/libinfimum_native.so): same hashes, same tree semantics, same byte
contracts, same pairing check — golden-tested against both the Python stack
and the reference fixtures. `groth16_verify` calls the port's own copy of
the verifier (infimum_tpu_torch/native/libinfimum_verify.so), which also
keeps each call's phase boundaries (`verify_last_phases`) and carries the
Groth16 prover's host tail (`msm_combine`, `groth16_assemble`). The port
requires both libraries: they load at first use, built by `make -C native`
and `make -C infimum_tpu_torch/native` where they are missing (the port's
library is rebuilt once where the one on disk lacks a symbol this module
binds), and every binding raises RuntimeError where one cannot be built or
loaded.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libinfimum_native.so"
_VERIFY_DIR = pathlib.Path(__file__).resolve().parent
_VERIFY_PATH = _VERIFY_DIR / "libinfimum_verify.so"

_VERIFY_SYMBOLS = ("inf_groth16_verify", "inf_verify_last_phases",
                   "inf_msm_combine_g1", "inf_msm_combine_g2",
                   "inf_groth16_assemble")

_lib = None
_vlib = None   # the port's verifier and prover tail


def _make(directory: pathlib.Path, path: pathlib.Path, *flags: str) -> None:
    """`make -C directory flags`, which builds the library at `path`;
    RuntimeError, naming `path` and the tail of make's stderr, where it
    fails."""
    try:
        subprocess.run(["make", "-C", str(directory), *flags], check=True,
                       capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        err = e.stderr.decode(errors="replace")[-2000:]
        raise RuntimeError(f"cannot build {path}: {err}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"cannot build {path}: {e}") from e


def _lacks(path: pathlib.Path, symbols) -> bool:
    """Whether the library at `path` lacks one of `symbols`, read from its
    string table before it is loaded: a library once loaded stays in the
    process, so a rebuilt one could not replace it."""
    data = path.read_bytes()
    return any(b"\0" + s.encode() + b"\0" not in data for s in symbols)


def _open(directory: pathlib.Path, path: pathlib.Path, symbols=()):
    """The library at `path`, built by `make -C directory` where it is
    missing, and rebuilt once (`make -B`) where it lacks one of `symbols`;
    RuntimeError, naming `path`, where it cannot be built or loaded."""
    if not path.exists():
        _make(directory, path)
    if _lacks(path, symbols):
        _make(directory, path, "-B")
        if _lacks(path, symbols):
            raise RuntimeError(f"{path} lacks one of {symbols} once rebuilt")
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e


def _load():
    """The repo-root library, loaded (with the port's, `_vlib`) at first
    use; `_open`'s RuntimeError where either cannot be."""
    global _lib, _vlib
    if _lib is not None:
        return _lib
    lib = _open(_NATIVE_DIR, _LIB_PATH)
    vlib = _open(_VERIFY_DIR, _VERIFY_PATH, _VERIFY_SYMBOLS)
    lib.inf_imt_new.restype = ctypes.c_void_p
    lib.inf_imt_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.inf_imt_free.argtypes = [ctypes.c_void_p]
    lib.inf_imt_insert.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.inf_imt_merge.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.inf_imt_root.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.inf_imt_depth.argtypes = [ctypes.c_void_p]
    lib.inf_imt_count.argtypes = [ctypes.c_void_p]
    lib.inf_imt_count.restype = ctypes.c_uint64
    lib.inf_blake512.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_char_p]
    lib.inf_blake512.restype = None
    lib.inf_hintprog_new.restype = ctypes.c_void_p
    lib.inf_hintprog_new.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int]
    lib.inf_hintprog_free.argtypes = [ctypes.c_void_p]
    lib.inf_hintprog_run.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p]
    vlib.inf_verify_last_phases.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    vlib.inf_verify_last_phases.restype = None
    for name in ("inf_msm_combine_g1", "inf_msm_combine_g2"):
        fn = getattr(vlib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_char_p]
        fn.restype = ctypes.c_int
    vlib.inf_groth16_assemble.argtypes = [ctypes.c_char_p] * 5
    vlib.inf_groth16_assemble.restype = ctypes.c_int
    _lib, _vlib = lib, vlib
    return _lib


def available() -> bool:
    """Whether both libraries load."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _fr_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


def poseidon(inputs: list[int]) -> int:
    """Native circom Poseidon (same contract as hash/poseidon_host.py)."""
    lib = _load()
    buf = b"".join(_fr_bytes(x) for x in inputs)
    out = ctypes.create_string_buffer(32)
    rc = lib.inf_poseidon(buf, len(inputs), out)
    if rc != 0:
        raise ValueError(f"native poseidon failed rc={rc}")
    return int.from_bytes(out.raw, "big")


def poseidon2_batch(pairs: list[tuple[int, int]]) -> list[int]:
    """Batched Poseidon2 (Merkle level hashing on the host)."""
    lib = _load()
    buf = b"".join(_fr_bytes(a) + _fr_bytes(b) for a, b in pairs)
    out = ctypes.create_string_buffer(32 * len(pairs))
    lib.inf_poseidon2_batch(buf, len(pairs), out)
    return [int.from_bytes(out.raw[32 * i: 32 * i + 32], "big")
            for i in range(len(pairs))]


def poseidon_perm(state: list[int]) -> list[int]:
    """Native full Poseidon permutation (hash/poseidon_host.poseidon_perm
    contract; the duplex cipher needs all t output elements)."""
    lib = _load()
    t = len(state)
    buf = b"".join(_fr_bytes(x) for x in state)
    out = ctypes.create_string_buffer(32 * t)
    rc = lib.inf_poseidon_perm(buf, t, out)
    if rc != 0:
        raise ValueError(f"native poseidon_perm failed rc={rc}")
    return [int.from_bytes(out.raw[32 * i: 32 * i + 32], "big")
            for i in range(t)]


def poseidon_batch(rows: list[list[int]], n: int) -> list[int]:
    """Batched width-n Poseidon hash over m rows (one boundary crossing)."""
    lib = _load()
    m = len(rows)
    buf = b"".join(_fr_bytes(x) for row in rows for x in row)
    out = ctypes.create_string_buffer(32 * m)
    rc = lib.inf_poseidon_batch(buf, n, m, out)
    if rc != 0:
        raise ValueError(f"native poseidon_batch failed rc={rc}")
    return [int.from_bytes(out.raw[32 * i: 32 * i + 32], "big")
            for i in range(m)]


class NativeIMT:
    """Native amortized incremental Merkle tree (tree/imt.py semantics,
    reference pallet/src/poll/state.rs:176-281)."""

    def __init__(self, arity: int, full_depth: int, zero_seed: bool = False):
        self._lib = _load()
        self._h = self._lib.inf_imt_new(arity, full_depth, int(zero_seed))
        self.arity = arity
        self.full_depth = full_depth

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.inf_imt_free(self._h)
            self._h = None

    def insert(self, leaf: int) -> None:
        rc = self._lib.inf_imt_insert(self._h, _fr_bytes(leaf))
        if rc != 0:
            from ..tree.imt import MerkleTreeError

            raise MerkleTreeError(rc)

    def merge(self, to_depth: bool) -> None:
        rc = self._lib.inf_imt_merge(self._h, int(to_depth))
        if rc != 0:
            from ..tree.imt import MerkleTreeError

            raise MerkleTreeError(rc)

    @property
    def root(self) -> int | None:
        out = ctypes.create_string_buffer(32)
        if not self._lib.inf_imt_root(self._h, out):
            return None
        return int.from_bytes(out.raw, "big")

    @property
    def depth(self) -> int:
        return self._lib.inf_imt_depth(self._h)

    @property
    def count(self) -> int:
        return self._lib.inf_imt_count(self._h)


def bjj_mul(p: tuple[int, int], n: int) -> tuple[int, int]:
    """Native BabyJubJub scalar multiplication (curve/babyjubjub.py twin)."""
    lib = _load()
    out = ctypes.create_string_buffer(64)
    rc = lib.inf_bjj_mul(_fr_bytes(p[0]) + _fr_bytes(p[1]),
                         int(n).to_bytes(32, "big"), out)
    if rc != 0:
        raise ValueError(f"native bjj_mul failed rc={rc}")
    return (int.from_bytes(out.raw[:32], "big"),
            int.from_bytes(out.raw[32:], "big"))


def bjj_add(p: tuple[int, int], q: tuple[int, int]) -> tuple[int, int]:
    """Native BabyJubJub point addition."""
    lib = _load()
    out = ctypes.create_string_buffer(64)
    rc = lib.inf_bjj_add(_fr_bytes(p[0]) + _fr_bytes(p[1]),
                         _fr_bytes(q[0]) + _fr_bytes(q[1]), out)
    if rc != 0:
        raise ValueError(f"native bjj_add failed rc={rc}")
    return (int.from_bytes(out.raw[:32], "big"),
            int.from_bytes(out.raw[32:], "big"))


def blake512(data: bytes) -> bytes:
    """Native BLAKE-512 (utils/blake512.py twin)."""
    lib = _load()
    out = ctypes.create_string_buffer(64)
    lib.inf_blake512(bytes(data), len(data), out)
    return out.raw


class NativeHintProg:
    """Compiled witness hint program (native/src/hintprog.cc). Built once
    per ConstraintSystem from numpy op/term arrays; `run` evaluates the
    full witness from an input assignment."""

    def __init__(self, ops, term_idx, term_coeff_be: bytes, num_vars: int):
        import numpy as np

        self._lib = _load()
        self._ops = np.ascontiguousarray(ops, dtype=np.int64)
        self._idx = np.ascontiguousarray(term_idx, dtype=np.uint32)
        self.num_vars = num_vars
        self._h = self._lib.inf_hintprog_new(
            self._ops.ctypes.data_as(ctypes.c_void_p),
            len(self._ops) // 7,
            self._idx.ctypes.data_as(ctypes.c_void_p),
            term_coeff_be, len(self._idx), num_vars)
        if not self._h:
            raise ValueError("native hint program rejected (bad coeff)")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.inf_hintprog_free(self._h)
            self._h = None

    def run(self, inputs: dict[int, int]) -> list[int]:
        import numpy as np

        idx = np.fromiter(inputs.keys(), np.uint32, count=len(inputs))
        vals = b"".join(_fr_bytes(v) for v in inputs.values())
        out = ctypes.create_string_buffer(32 * self.num_vars)
        rc = self._lib.inf_hintprog_run(
            self._h, idx.ctypes.data_as(ctypes.c_void_p), vals, len(inputs),
            out)
        if rc != 0:
            raise ValueError(f"native hint program failed rc={rc}")
        raw = out.raw
        return [int.from_bytes(raw[32 * i: 32 * i + 32], "big")
                for i in range(self.num_vars)]


def merkle_zero(arity: int, depth: int) -> int:
    lib = _load()
    out = ctypes.create_string_buffer(32)
    rc = lib.inf_merkle_zero(arity, depth, out)
    if rc != 0:
        raise ValueError("bad zero-table index")
    return int.from_bytes(out.raw, "big")


def g1_validate(b: bytes) -> bool:
    return _load().inf_g1_validate(bytes(b)) == 0


def g2_validate(b: bytes) -> bool:
    return _load().inf_g2_validate(bytes(b)) == 0


def g1_roundtrip(b: bytes) -> bytes:
    out = ctypes.create_string_buffer(64)
    if _load().inf_g1_roundtrip(bytes(b), out) != 0:
        raise ValueError("malformed G1")
    return out.raw


def g2_roundtrip(b: bytes) -> bytes:
    out = ctypes.create_string_buffer(128)
    if _load().inf_g2_roundtrip(bytes(b), out) != 0:
        raise ValueError("malformed G2")
    return out.raw


def groth16_verify(vk_bytes: dict, proof_bytes: dict,
                   publics: list[int]) -> bool:
    """Native pairing verification over pallet-shaped byte containers
    (the {alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1} /
    {pi_a, pi_b, pi_c} dicts of io/arkworks.py)."""
    _load()
    ic = b"".join(bytes(p) for p in vk_bytes["gamma_abc_g1"])
    pub = b"".join(_fr_bytes(x) for x in publics)
    rc = _vlib.inf_groth16_verify(
        bytes(vk_bytes["alpha_g1"]), bytes(vk_bytes["beta_g2"]),
        bytes(vk_bytes["gamma_g2"]), bytes(vk_bytes["delta_g2"]),
        ic, len(vk_bytes["gamma_abc_g1"]),
        bytes(proof_bytes["pi_a"]), bytes(proof_bytes["pi_b"]),
        bytes(proof_bytes["pi_c"]), pub, len(publics))
    if rc < 0:
        raise ValueError(f"malformed verify input rc={rc}")
    return rc == 1


def verify_last_phases() -> list[float]:
    """The phase boundaries of this thread's last `groth16_verify`, in
    seconds of CLOCK_MONOTONIC (time.perf_counter's clock on Linux): its
    start, the end of the checks, of the Miller product and of the final
    exponentiation; 0.0 for a boundary the call did not reach."""
    out = (ctypes.c_int64 * 4)()
    _load()
    _vlib.inf_verify_last_phases(out)
    return [ns * 1e-9 for ns in out]


# -- the Groth16 prover's host tail (src/prove_tail.cc) ---------------------
#
# A point crosses to the library in standard form, 32-byte little-endian
# coordinates: G1 (x, y), 64 bytes; G2 ((x0, x1), (y0, y1)), 128 bytes, c0
# first; all zero bytes for infinity (None).

POINT_BYTES = {"g1": 64, "g2": 128}


def point_bytes(p, curve: str) -> bytes:
    """A host affine point (curve/bn254_host.py's tuples, None for
    infinity) as the library reads it."""
    if p is None:
        return bytes(POINT_BYTES[curve])
    coords = p if curve == "g1" else (*p[0], *p[1])
    return b"".join(int(c).to_bytes(32, "little") for c in coords)


def point_from_bytes(b: bytes, curve: str):
    """The inverse of `point_bytes`."""
    if not any(b):
        return None
    c = [int.from_bytes(b[i:i + 32], "little") for i in range(0, len(b), 32)]
    return (c[0], c[1]) if curve == "g1" else ((c[0], c[1]), (c[2], c[3]))


def msm_combine(words, curve: str, c_bits: int):
    """One MSM's window sums -> its host affine point (None for infinity):
    Horner over the windows in Jacobian coordinates, one inversion.
    `words`: the (nwin, PW) int32 words of the windows' homogeneous
    projective (X, Y, Z), Montgomery form, least significant window first
    (msm/msm.py `msm_rows_words`)."""
    import numpy as np

    w = np.ascontiguousarray(words, dtype=np.int32)
    pw = 3 * POINT_BYTES[curve] // 8    # 32-bit words of (X, Y, Z)
    if w.ndim != 2 or w.shape[1] != pw:
        raise ValueError(f"want (nwin, {pw}) words, got {w.shape}")
    _load()
    out = ctypes.create_string_buffer(POINT_BYTES[curve])
    fn = (_vlib.inf_msm_combine_g1 if curve == "g1"
          else _vlib.inf_msm_combine_g2)
    rc = fn(w.ctypes.data_as(ctypes.c_void_p), w.shape[0], c_bits, out)
    if rc != 0:
        raise ValueError(f"native msm combine failed rc={rc}")
    return point_from_bytes(out.raw, curve)


def groth16_assemble(key: bytes, sums, r: int, s: int):
    """(A, B, C) of a Groth16 proof, as host affine points: A = alpha + a +
    r delta, B = beta_2 + b2 + s delta_2, C = l + h + s A + r (beta_1 + b1 +
    s delta) - r s delta. `key`: alpha_g1, beta_g1, delta_g1, beta_g2,
    delta_g2 as `point_bytes`, joined; `sums`: the MSMs' points a, b1, l, h
    (G1) and b2 (G2); r, s below |Fr|."""
    _load()
    sb = b"".join(point_bytes(p, c) for p, c in
                  zip(sums, ("g1", "g1", "g1", "g1", "g2")))
    out = ctypes.create_string_buffer(256)
    rc = _vlib.inf_groth16_assemble(bytes(key), sb,
                                    int(r).to_bytes(32, "little"),
                                    int(s).to_bytes(32, "little"), out)
    if rc != 0:
        raise ValueError(f"native groth16 assemble failed rc={rc}")
    raw = out.raw
    return (point_from_bytes(raw[:64], "g1"),
            point_from_bytes(raw[64:192], "g2"),
            point_from_bytes(raw[192:], "g1"))
