# Copied from infimum_tpu/io/snarkjs.py; the Montgomery decode multiplies by
# R^-1 kept per modulus (the same values, without an exponentiation per value).
"""snarkjs / circom binary artifact interop: .r1cs, .wtns, .zkey (Groth16).

The reference's prover consumes circom build artifacts produced per
circuits/README.md:10-33 (`circom --r1cs --wasm`, `snarkjs groth16 setup`
-> process.zkey / tally.zkey) and proves with `snarkjs.groth16.fullProve`
(reference cli/src/utils.ts:69-92). This module lets the native prover
serve those same ceremony artifacts: read a .zkey and prove against its
(deployed) verifying key, read/write .r1cs constraint systems and .wtns
witness files, and export a native setup *as* a .zkey.

Formats follow iden3's binfile container (4-byte magic, u32 version,
u32 nSections, then [u32 type, u64 size, payload] sections):

  .wtns v2: S1 header (n8, prime LE, nWitness), S2 values (n8-byte LE each).
  .r1cs v1: S1 header (n8, prime, nVars, nOutputs, nPubIn, nPrvIn,
            nLabels u64, nConstraints), S2 constraints (per constraint and
            per A/B/C matrix: u32 nTerms then [u32 wireId, n8-byte LE coeff]),
            S3 wire-to-label map (u64 per wire).
  .zkey v1 (Groth16): S1 protocol id (1); S2 Groth header (n8q, q, n8r, r,
            nVars, nPublic, domainSize, alpha1, beta1, delta1 G1s then
            beta2, gamma2, delta2 G2s); S3 IC; S4 A/B coefficient triples
            (u32 matrix, u32 row, u32 signal, Fr value); S5 A-query;
            S6 B1-query; S7 B2-query; S8 C(L)-query (private signals);
            S9 H-query (domainSize points); S10 MPC contributions.

All .zkey group/field values are little-endian **Montgomery** residues
(R = 2^256), matching ffjavascript's `toRprLEM`; .r1cs/.wtns values are
plain little-endian residues. G1 = (x, y) 32B each, G2 = (x.c0, x.c1,
y.c0, y.c1); the point at infinity is encoded as all zeros (Montgomery
zero is zero).

The .zkey H-query basis is the one snarkjs's prover contracts to: the
prover evaluates P = A.B - C on the "odd" coset {eta w^i} (eta = w_{2n},
so Z == -2 there) and multiplies straight into the H points, hence
  H_i = [ L_i(tau/eta) * Z(tau) / (-2 delta) ]_1
with L_i the standard Lagrange basis over the radix-2 domain. A zkey
written here proves and verifies under the same pipeline that consumes
ceremony zkeys (see prove_zkey / tests/test_snarkjs_io.py roundtrips).
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass, field

from ..ff.bn254 import FQ_MOD, FR_MOD, fr_inv
from ..groth16.r1cs import ConstraintSystem, LC

Q = FQ_MOD
P = FR_MOD
N8 = 32
R_MONT = 1 << 256


def _to_mont(x: int, mod: int) -> int:
    return x * R_MONT % mod


_R_INV = {Q: pow(R_MONT, Q - 2, Q), P: pow(R_MONT, P - 2, P)}


def _from_mont(x: int, mod: int) -> int:
    return x * _R_INV[mod] % mod


# -- binfile container ---------------------------------------------------------

class _Writer:
    def __init__(self, magic: bytes, version: int):
        self.buf = _io.BytesIO()
        self.magic = magic
        self.version = version
        self.sections: list[tuple[int, bytes]] = []

    def section(self, stype: int, payload: bytes):
        self.sections.append((stype, payload))

    def tobytes(self) -> bytes:
        out = _io.BytesIO()
        out.write(self.magic)
        out.write(struct.pack("<II", self.version, len(self.sections)))
        for stype, payload in self.sections:
            out.write(struct.pack("<IQ", stype, len(payload)))
            out.write(payload)
        return out.getvalue()


def _read_sections(data: bytes, magic: bytes) -> dict[int, bytes]:
    if data[:4] != magic:
        raise ValueError(f"bad magic {data[:4]!r}, want {magic!r}")
    _version, nsec = struct.unpack_from("<II", data, 4)
    pos = 12
    sections: dict[int, bytes] = {}
    for _ in range(nsec):
        stype, size = struct.unpack_from("<IQ", data, pos)
        pos += 12
        sections[stype] = data[pos : pos + size]
        pos += size
    return sections


def _fr_le(x: int) -> bytes:
    return (x % P).to_bytes(N8, "little")


def _g1_lem(p) -> bytes:
    if p is None:
        return bytes(2 * N8)
    x, y = p
    return (_to_mont(x, Q).to_bytes(N8, "little")
            + _to_mont(y, Q).to_bytes(N8, "little"))


def _g1_from_lem(b: bytes):
    x = _from_mont(int.from_bytes(b[:N8], "little"), Q)
    y = _from_mont(int.from_bytes(b[N8 : 2 * N8], "little"), Q)
    if x == 0 and y == 0:
        return None
    return (x, y)


def _g2_lem(p) -> bytes:
    if p is None:
        return bytes(4 * N8)
    (x0, x1), (y0, y1) = p
    return b"".join(_to_mont(v, Q).to_bytes(N8, "little")
                    for v in (x0, x1, y0, y1))


def _g2_from_lem(b: bytes):
    v = [_from_mont(int.from_bytes(b[i * N8 : (i + 1) * N8], "little"), Q)
         for i in range(4)]
    if all(c == 0 for c in v):
        return None
    return ((v[0], v[1]), (v[2], v[3]))


# -- .wtns ---------------------------------------------------------------------

def write_wtns(witness: list[int]) -> bytes:
    w = _Writer(b"wtns", 2)
    w.section(1, struct.pack("<I", N8) + P.to_bytes(N8, "little")
              + struct.pack("<I", len(witness)))
    w.section(2, b"".join(_fr_le(v) for v in witness))
    return w.tobytes()


def read_wtns(data: bytes) -> list[int]:
    sec = _read_sections(data, b"wtns")
    n8, = struct.unpack_from("<I", sec[1], 0)
    prime = int.from_bytes(sec[1][4 : 4 + n8], "little")
    if prime != P:
        raise ValueError("wtns prime is not BN254 Fr")
    nw, = struct.unpack_from("<I", sec[1], 4 + n8)
    vals = sec[2]
    return [int.from_bytes(vals[i * n8 : (i + 1) * n8], "little")
            for i in range(nw)]


# -- .r1cs ---------------------------------------------------------------------

@dataclass
class R1csFile:
    n_vars: int
    n_outputs: int
    n_pub_inputs: int
    n_prv_inputs: int
    n_labels: int
    constraints: list  # (dictA, dictB, dictC) wire->coeff
    wire2label: list[int] = field(default_factory=list)

    @property
    def n_public(self) -> int:
        return self.n_outputs + self.n_pub_inputs

    def to_constraint_system(self) -> ConstraintSystem:
        cs = ConstraintSystem()
        cs.num_public = self.n_public
        cs.num_vars = self.n_vars
        for a, b, c in self.constraints:
            cs.enforce(LC(a), LC(b), LC(c))
        return cs


def write_r1cs(cs: ConstraintSystem, n_outputs: int = 0) -> bytes:
    w = _Writer(b"r1cs", 1)
    n_pub_in = cs.num_public - n_outputs
    n_prv = cs.num_vars - cs.num_public - 1
    w.section(1, struct.pack("<I", N8) + P.to_bytes(N8, "little")
              + struct.pack("<IIIIQI", cs.num_vars, n_outputs, n_pub_in,
                            n_prv, cs.num_vars, len(cs.constraints)))
    body = _io.BytesIO()
    for a, b, c in cs.constraints:
        for lc in (a, b, c):
            items = sorted(lc.terms.items())
            body.write(struct.pack("<I", len(items)))
            for wire, coeff in items:
                body.write(struct.pack("<I", wire))
                body.write(_fr_le(coeff))
    w.section(2, body.getvalue())
    w.section(3, b"".join(struct.pack("<Q", i) for i in range(cs.num_vars)))
    return w.tobytes()


def read_r1cs(data: bytes) -> R1csFile:
    sec = _read_sections(data, b"r1cs")
    n8, = struct.unpack_from("<I", sec[1], 0)
    prime = int.from_bytes(sec[1][4 : 4 + n8], "little")
    if prime != P:
        raise ValueError("r1cs prime is not BN254 Fr")
    n_vars, n_out, n_pub, n_prv, n_labels, n_cons = struct.unpack_from(
        "<IIIIQI", sec[1], 4 + n8)
    body = sec[2]
    pos = 0
    constraints = []
    for _ in range(n_cons):
        mats = []
        for _ in range(3):
            nterms, = struct.unpack_from("<I", body, pos)
            pos += 4
            terms = {}
            for _ in range(nterms):
                wire, = struct.unpack_from("<I", body, pos)
                pos += 4
                coeff = int.from_bytes(body[pos : pos + n8], "little")
                pos += n8
                terms[wire] = coeff % P
            mats.append(terms)
        constraints.append(tuple(mats))
    wire2label = []
    if 3 in sec:
        lab = sec[3]
        wire2label = [struct.unpack_from("<Q", lab, 8 * i)[0]
                      for i in range(len(lab) // 8)]
    return R1csFile(n_vars, n_out, n_pub, n_prv, n_labels,
                    constraints, wire2label)


# -- .zkey ---------------------------------------------------------------------

GROTH16_PROTOCOL_ID = 1


@dataclass
class ZkeyData:
    n_vars: int
    n_public: int
    domain_size: int
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    ic: list
    coeffs: list        # (matrix 0|1, row, signal, value) — value plain residue
    a_query: list       # G1, n_vars
    b1_query: list      # G1, n_vars
    b2_query: list      # G2, n_vars
    c_query: list       # G1, n_vars - n_public - 1 (private signals)
    h_query: list       # G1, domain_size (odd-coset Lagrange basis, see module doc)


def read_zkey(data: bytes) -> ZkeyData:
    sec = _read_sections(data, b"zkey")
    proto, = struct.unpack_from("<I", sec[1], 0)
    if proto != GROTH16_PROTOCOL_ID:
        raise ValueError(f"not a Groth16 zkey (protocol {proto})")
    h = sec[2]
    n8q, = struct.unpack_from("<I", h, 0)
    q = int.from_bytes(h[4 : 4 + n8q], "little")
    pos = 4 + n8q
    n8r, = struct.unpack_from("<I", h, pos)
    r = int.from_bytes(h[pos + 4 : pos + 4 + n8r], "little")
    pos += 4 + n8r
    if q != Q or r != P:
        raise ValueError("zkey is not over BN254")
    n_vars, n_public, domain_size = struct.unpack_from("<III", h, pos)
    pos += 12
    alpha_g1 = _g1_from_lem(h[pos : pos + 64]); pos += 64
    beta_g1 = _g1_from_lem(h[pos : pos + 64]); pos += 64
    delta_g1 = _g1_from_lem(h[pos : pos + 64]); pos += 64
    beta_g2 = _g2_from_lem(h[pos : pos + 128]); pos += 128
    gamma_g2 = _g2_from_lem(h[pos : pos + 128]); pos += 128
    delta_g2 = _g2_from_lem(h[pos : pos + 128]); pos += 128

    def g1s(b: bytes) -> list:
        return [_g1_from_lem(b[i * 64 : (i + 1) * 64])
                for i in range(len(b) // 64)]

    def g2s(b: bytes) -> list:
        return [_g2_from_lem(b[i * 128 : (i + 1) * 128])
                for i in range(len(b) // 128)]

    cb = sec[4]
    ncoef, = struct.unpack_from("<I", cb, 0)
    coeffs = []
    pos = 4
    for _ in range(ncoef):
        m, row, sig = struct.unpack_from("<III", cb, pos)
        pos += 12
        val = _from_mont(int.from_bytes(cb[pos : pos + N8], "little"), P)
        pos += N8
        coeffs.append((m, row, sig, val))

    return ZkeyData(
        n_vars=n_vars, n_public=n_public, domain_size=domain_size,
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g1=delta_g1, delta_g2=delta_g2,
        ic=g1s(sec[3]), coeffs=coeffs,
        a_query=g1s(sec[5]), b1_query=g1s(sec[6]), b2_query=g2s(sec[7]),
        c_query=g1s(sec[8]), h_query=g1s(sec[9]),
    )


def write_zkey(zk: ZkeyData) -> bytes:
    w = _Writer(b"zkey", 1)
    w.section(1, struct.pack("<I", GROTH16_PROTOCOL_ID))
    h = _io.BytesIO()
    h.write(struct.pack("<I", N8) + Q.to_bytes(N8, "little"))
    h.write(struct.pack("<I", N8) + P.to_bytes(N8, "little"))
    h.write(struct.pack("<III", zk.n_vars, zk.n_public, zk.domain_size))
    h.write(_g1_lem(zk.alpha_g1) + _g1_lem(zk.beta_g1) + _g1_lem(zk.delta_g1))
    h.write(_g2_lem(zk.beta_g2) + _g2_lem(zk.gamma_g2) + _g2_lem(zk.delta_g2))
    w.section(2, h.getvalue())
    w.section(3, b"".join(_g1_lem(p) for p in zk.ic))
    cb = _io.BytesIO()
    cb.write(struct.pack("<I", len(zk.coeffs)))
    for m, row, sig, val in zk.coeffs:
        cb.write(struct.pack("<III", m, row, sig))
        cb.write(_to_mont(val, P).to_bytes(N8, "little"))
    w.section(4, cb.getvalue())
    w.section(5, b"".join(_g1_lem(p) for p in zk.a_query))
    w.section(6, b"".join(_g1_lem(p) for p in zk.b1_query))
    w.section(7, b"".join(_g2_lem(p) for p in zk.b2_query))
    w.section(8, b"".join(_g1_lem(p) for p in zk.c_query))
    w.section(9, b"".join(_g1_lem(p) for p in zk.h_query))
    # S10: MPC contribution transcript — none for a locally generated key
    w.section(10, bytes(64) + struct.pack("<I", 0))
    return w.tobytes()
