# Copied from infimum_tpu/groth16/r1cs.py; the port keeps its own host layers.
"""R1CS constraint system and circuit-builder DSL over BN254 Fr.

The reference gets its constraint systems from circom (circuits/*.circom
compiled by circom+snarkjs, circuits/README.md:10-33). This framework builds
them natively: a `ConstraintSystem` holds sparse A/B/C rows over a variable
vector [1, publics..., witness...], and `LC` (linear combination) gives the
few algebraic helpers the MACI circuits need. Witness generation is separate
(witness/): the builder registers per-gate hint functions so a full
assignment can be computed from the input assignment alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ff.bn254 import FR_MOD

P = FR_MOD


class LC:
    """Sparse linear combination {var_index: coeff} over Fr."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})

    @staticmethod
    def const(c: int) -> "LC":
        c %= P
        return LC({0: c} if c else {})

    @staticmethod
    def var(i: int, c: int = 1) -> "LC":
        c %= P
        return LC({i: c} if c else {})

    def __add__(self, other):
        if isinstance(other, int):
            other = LC.const(other)
        out = dict(self.terms)
        for i, c in other.terms.items():
            nc = (out.get(i, 0) + c) % P
            if nc:
                out[i] = nc
            else:
                out.pop(i, None)
        return LC(out)

    def __sub__(self, other):
        if isinstance(other, int):
            other = LC.const(other)
        return self + other.scale(P - 1)

    def scale(self, k: int) -> "LC":
        k %= P
        return LC({i: (c * k) % P for i, c in self.terms.items()} if k else {})

    def eval(self, assignment) -> int:
        # hot loop #1 (witnessing + checking walks millions of terms):
        # a plain loop beats the genexpr-in-sum by ~30% in CPython
        acc = 0
        for i, c in self.terms.items():
            acc += c * assignment[i]
        return acc % P

    def is_const(self):
        return all(i == 0 for i in self.terms)

    @property
    def const_value(self):
        return self.terms.get(0, 0)


@dataclass
class ConstraintSystem:
    """num_vars includes var 0 == 1; publics are vars 1..num_public."""

    num_public: int = 0
    num_vars: int = 1
    constraints: list = field(default_factory=list)  # (A, B, C) LC triples
    hints: list = field(default_factory=list)        # (out_idx, fn, in_lcs)

    # -- building -------------------------------------------------------------

    def alloc_public(self) -> int:
        assert self.num_vars == self.num_public + 1, \
            "public inputs must be allocated before witness vars"
        self.num_public += 1
        self.num_vars += 1
        return self.num_vars - 1

    def alloc(self) -> int:
        self.num_vars += 1
        return self.num_vars - 1

    def enforce(self, a: LC, b: LC, c: LC):
        """a * b = c."""
        self.constraints.append((a, b, c))

    def enforce_zero(self, lc: LC):
        self.enforce(lc, LC.const(1), LC.const(0))

    # -- gate helpers (allocate + constrain + hint) ---------------------------

    def hint(self, out_idx, fn, in_lcs, op=None):
        """During witnessing, assignment[out_idx] = fn(*[lc.eval(w)]).

        `op` optionally names the hint semantics as ("opname", int_param)
        from the closed set {mul, inv0, isz, bit, div0, digit5} so the
        native evaluator (native/src/hintprog.cc) can run the whole hint
        program in C++; untagged hints force the Python interpreter."""
        self.hints.append((out_idx, fn, list(in_lcs), op))

    def mul(self, a: LC, b: LC) -> LC:
        """Product gate returning a new LC."""
        if a.is_const():
            return b.scale(a.const_value)
        if b.is_const():
            return a.scale(b.const_value)
        v = self.alloc()
        self.enforce(a, b, LC.var(v))
        self.hint(v, lambda x, y: x * y % P, (a, b), op=("mul", 0))
        return LC.var(v)

    def square(self, a: LC) -> LC:
        return self.mul(a, a)

    def assert_bool(self, a: LC):
        self.enforce(a, a - LC.const(1), LC.const(0))

    def is_zero(self, a: LC) -> LC:
        """Returns LC of a bit that is 1 iff a == 0 (circomlib IsZero)."""
        inv = self.alloc()
        out = self.alloc()
        self.hint(inv, lambda x: pow(x, -1, P) if x else 0, (a,),
                  op=("inv0", 0))
        self.hint(out, lambda x: 0 if x else 1, (a,), op=("isz", 0))
        out_lc = LC.var(out)
        # out = -a*inv + 1 ;  a*out = 0
        self.enforce(a, LC.var(inv), LC.const(1) - out_lc)
        self.enforce(a, out_lc, LC.const(0))
        return out_lc

    def num2bits(self, a: LC, nbits: int) -> list[LC]:
        bits = []
        acc = LC()
        for k in range(nbits):
            v = self.alloc()
            self.hint(v, (lambda kk: lambda x: (x >> kk) & 1)(k), (a,),
                      op=("bit", k))
            b = LC.var(v)
            self.assert_bool(b)
            bits.append(b)
            acc = acc + b.scale(1 << k)
        self.enforce_zero(acc - a)
        return bits

    # -- witnessing -----------------------------------------------------------

    def _hint_program(self):
        """Hints compiled to an arity-specialized program (cached).

        The generic loop costs ~2 us/hint in CPython (list build + dict
        walk per LC); almost every hint input is a single {var: 1} term, so
        the compiled form replaces LC.eval with direct indexing and
        dispatches on (arity, all-plain-vars) — SURVEY.md §3.2 hot loop #1
        is this interpreter at ~10^5 hints per process batch.
        Forms: (1, out, fn, i) / (2, out, fn, i, j) -> plain-var args;
        (0, out, fn, lcs) -> general fallback."""
        prog = self.__dict__.get("_hint_prog")
        if prog is None or self.__dict__.get("_hint_prog_n") != len(self.hints):
            prog = []
            for out_idx, fn, in_lcs, _op in self.hints:
                idxs = []
                for lc in in_lcs:
                    t = lc.terms
                    if len(t) == 1:
                        (i, c), = t.items()
                        if c == 1 and i != 0:
                            idxs.append(i)
                            continue
                    idxs = None
                    break
                if idxs is not None and len(idxs) == 1:
                    prog.append((1, out_idx, fn, idxs[0]))
                elif idxs is not None and len(idxs) == 2:
                    prog.append((2, out_idx, fn, idxs[0], idxs[1]))
                else:
                    # general inputs flattened to ((i, c), ...) pair tuples
                    # (var 0 == 1 absorbs the constant term): an inline
                    # accumulation loop beats LC.eval's method call + dict
                    # walk ~2.5x over the ~2x10^5 evals per process batch
                    pairs = tuple(tuple(lc.terms.items()) for lc in in_lcs)
                    prog.append((0, out_idx, fn, pairs))
            self._hint_prog = prog
            self._hint_prog_n = len(self.hints)
        return prog

    _NATIVE_OPCODES = {"mul": 0, "inv0": 1, "isz": 2, "bit": 3,
                       "div0": 4, "digit5": 5}

    def _native_prog(self):
        """Compiled native hint program, or None where a hint carries no
        op tag the native program knows. Cached per hint count."""
        cached = self.__dict__.get("_native_prog_cache")
        if cached is not None and cached[0] == len(self.hints):
            return cached[1]
        prog = None
        if all(h[3] is not None and h[3][0] in self._NATIVE_OPCODES
               for h in self.hints):
            from .. import native

            ops, tidx, coeffs = [], [], []

            def flat(lc):
                off = len(tidx)
                for i, c in lc.terms.items():
                    tidx.append(i)
                    coeffs.append(int(c % P).to_bytes(32, "big"))
                return off, len(lc.terms)

            for out_idx, _fn, in_lcs, (name, param) in self.hints:
                a_off, a_len = flat(in_lcs[0])
                b_off, b_len = flat(in_lcs[1]) if len(in_lcs) > 1 \
                    else (0, 0)
                ops += [self._NATIVE_OPCODES[name], param, out_idx,
                        a_off, a_len, b_off, b_len]
            prog = native.NativeHintProg(
                ops, tidx, b"".join(coeffs), self.num_vars)
        self._native_prog_cache = (len(self.hints), prog)
        return prog

    def compute_witness(self, inputs: dict[int, int]) -> list[int]:
        """inputs: {var_index: value} for publics and primary witness vars.
        Hints run in registration order (builders register in topo order).
        Runs the native evaluator (native/src/hintprog.cc) when every hint
        carries an op tag it knows, else the Python interpreter below."""
        native_prog = self._native_prog()
        if native_prog is not None:
            return native_prog.run({i: v % P for i, v in inputs.items()})
        w = [0] * self.num_vars
        w[0] = 1
        for i, v in inputs.items():
            w[i] = v % P
        for item in self._hint_program():
            tag = item[0]
            if tag == 1:
                _, out_idx, fn, i = item
                w[out_idx] = fn(w[i]) % P
            elif tag == 2:
                _, out_idx, fn, i, j = item
                w[out_idx] = fn(w[i], w[j]) % P
            else:
                _, out_idx, fn, pairs = item
                vals = []
                for terms in pairs:
                    acc = 0
                    for i, c in terms:
                        acc += c * w[i]
                    vals.append(acc % P)
                w[out_idx] = fn(*vals) % P
        return w

    def mark(self, label: str):
        """Debug marker: label the constraint range that follows."""
        if not hasattr(self, "marks"):
            self.marks = []
        self.marks.append((len(self.constraints), label))

    def first_failure(self, w):
        """(index, label-of-enclosing-mark) of the first failing constraint."""
        for i, (a, b, c) in enumerate(self.constraints):
            if a.eval(w) * b.eval(w) % P != c.eval(w):
                label = None
                for pos, lab in getattr(self, "marks", []):
                    if pos <= i:
                        label = lab
                return i, label
        return None, None

    def check(self, w) -> bool:
        return all(
            a.eval(w) * b.eval(w) % P == c.eval(w) for a, b, c in self.constraints
        )

    def public_values(self, w) -> list[int]:
        return [w[i] for i in range(1, self.num_public + 1)]
