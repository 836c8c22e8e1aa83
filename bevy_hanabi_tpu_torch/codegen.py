"""One effect's particle step as generated CUDA C++.

The reference turns an effect's expression graph and modifiers into WGSL
(``EffectShaderSources::generate``, bevy_hanabi src/asset.rs:805-1335); the
JAX package traces the same walk into XLA, which fuses it. The port's eager
walk (:mod:`.compiler`, ``runtime/effect.py::_step_frame``) runs every node,
modifier and merge as its own pass over the pool. :func:`generate` walks the
same module, init modifiers and update modifiers and writes them out as C++:
one pass over the pool then does the spawn ranking, the init pass, the
merge, ``age += dt``, the lifetime kill, the motion integration and the
update modifiers for each lane, reading and writing each lane once
(``runtime/fused.py`` builds and launches it).

The text must compute what the eager walk computes, bit for bit, on the
card. So every node is written as the ATen operation the eager walk calls
computes it: the same CUDA math function (``sqrtf``, ``rsqrtf``, ``powf``,
``cosf``, ...), the NaN rules of ``clamp``, ``minimum`` and ``maximum``,
the order of a ``torch.sum`` over a vector's lanes, and no constant folding
(``0 + x`` is not ``x`` for ``x = -0``). Rand draws go through the PCG of
:mod:`.ops.rng` in native ``uint32``, in the eager walk's order and under its
memo rules: a handle is evaluated once a pass, a write of an attribute
forgets the reads of it and every node with operands. Literals are written
bit-exactly (hex floats). The text is a function of the asset alone.

An asset that needs anything without an emitter here raises
:class:`Unsupported`, naming it; its effect keeps the eager step.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .asset import EffectAsset, MotionIntegration, SimulationSpace
from .graph.expr import BinaryOp, BuiltInOp, TernaryOp, UnaryOp
from .values import BOOL, FLOAT, INT, UINT, ScalarType, VectorType

__all__ = [
    "Unsupported",
    "Field",
    "PropertySlot",
    "StepSource",
    "generate",
    "try_generate",
    "fuse_reason",
    "c_float",
    "FRAME_SCALARS",
    "HEADER_WORDS",
]

_TAU = 6.283185307179586476925286766559

# The frame's scalars, in the order of ``struct Frame``'s float fields.
FRAME_SCALARS = (
    BuiltInOp.TIME,
    BuiltInOp.DELTA_TIME,
    BuiltInOp.VIRTUAL_TIME,
    BuiltInOp.VIRTUAL_DELTA_TIME,
    BuiltInOp.REAL_TIME,
    BuiltInOp.REAL_DELTA_TIME,
)
# An instance's words start with its spawn count and hashed frame seed.
HEADER_WORDS = 2


class Unsupported(Exception):
    """The asset needs something the generator has no emitter for."""


_KINDS = {FLOAT: "f32", INT: "i32", UINT: "u32", BOOL: "bool"}
_CTYPE = {"f32": "float", "i32": "int32_t", "u32": "uint32_t", "bool": "bool"}


@dataclass(frozen=True)
class Field:
    """A storage attribute of the pool: element kind and lanes."""

    name: str
    kind: str
    lanes: int


@dataclass(frozen=True)
class PropertySlot:
    """A property's words in an instance's word block."""

    name: str
    kind: str
    lanes: int
    offset: int
    default: Tuple[int, ...]  # the declared default, as words


@dataclass(frozen=True)
class StepSource:
    """The generated source and what its launcher needs to be fed."""

    text: str
    fields: Tuple[Field, ...]
    properties: Tuple[PropertySlot, ...]
    words: int  # an instance's words: count, hash, [transform 12], properties
    global_space: bool

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.text.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# literals


def c_float(x) -> str:
    """``x`` rounded to f32, as a C++ expression of exactly that float: a hex
    float literal, or the bit pattern for a NaN or an infinity."""
    v = np.float32(x)
    if not np.isfinite(v):
        return f"bits_f(0x{int(np.array(v).view(np.uint32)):08x}u)"
    return float(v).hex() + "f"


def _c_int(x: int) -> str:
    x = int(np.int32(x))
    return "(-2147483647 - 1)" if x == -(2**31) else f"int32_t({x})"


def _c_literal(kind: str, x) -> str:
    if kind == "f32":
        return c_float(x)
    if kind == "i32":
        return _c_int(x)
    if kind == "u32":
        return f"0x{int(np.uint32(x)):08x}u"
    return "true" if bool(x) else "false"


def _kind_lanes(vt) -> Tuple[str, int]:
    if isinstance(vt, ScalarType):
        return _KINDS[vt], 1
    if isinstance(vt, VectorType):
        return _KINDS[vt.elem_type], vt.count
    raise Unsupported(f"value type {vt!r}")


def _words_of(kind: str, values) -> Tuple[int, ...]:
    a = np.asarray(values).reshape(-1)
    if kind == "f32":
        return tuple(int(w) for w in a.astype(np.float32).view(np.uint32))
    if kind == "i32":
        return tuple(int(w) for w in a.astype(np.int32).view(np.uint32))
    if kind == "u32":
        return tuple(int(w) for w in a.astype(np.uint32))
    return tuple(int(bool(w)) for w in a)


# ---------------------------------------------------------------------------
# values of one pass: every component a C++ name (or literal), SSA


@dataclass(frozen=True)
class _Val:
    kind: str
    comps: Tuple[str, ...]
    vec: bool  # a vector type (a 1-lane vector does not exist)

    @property
    def lanes(self) -> int:
        return len(self.comps)


def _sum_lanes(c: List[str]) -> str:
    """``torch.sum(x, dim=-1)`` of a vector's lanes on the card, in the order
    ATen's reduction adds them: two threads per output over three lanes
    (lanes 0 and 2 in one thread, then the other thread's lane 1), one a
    lane over four (pairs, then the pairs' sums)."""
    if len(c) == 2:
        return f"({c[0]} + {c[1]})"
    if len(c) == 3:
        return f"(({c[0]} + {c[2]}) + {c[1]})"
    if len(c) == 4:
        return f"(({c[0]} + {c[1]}) + ({c[2]} + {c[3]}))"
    raise Unsupported(f"a sum over {len(c)} lanes")


def _fmax_nan(a: str, b: str) -> str:
    # ATen's maximum / clamp_min on floats: a NaN operand propagates
    return f"max_nan({a}, {b})"


def _fmin_nan(a: str, b: str) -> str:
    return f"min_nan({a}, {b})"


class _Pass:
    """The emitter of one pass (init or update) over one lane: the eager
    walk's :class:`~.compiler.EvalContext` with C++ text for tensors."""

    def __init__(self, gen: "_Generator", context: str, particle: Dict[str, _Val]):
        self.gen = gen
        self.module = gen.asset.module
        self.context = context
        self.particle = particle
        self.memo: Dict[int, _Val] = {}
        self.lines: List[str] = []
        self._n = 0

    # -- text ------------------------------------------------------------

    def tmp(self, kind: str, expr: str) -> str:
        self._n += 1
        name = f"{self.context[0]}{self._n}"
        self.lines.append(f"const {_CTYPE[kind]} {name} = {expr};")
        return name

    def val(self, kind: str, exprs, vec: bool) -> _Val:
        return _Val(kind, tuple(self.tmp(kind, e) for e in exprs), vec)

    def stmt(self, s: str) -> None:
        self.lines.append(s)

    # -- context ---------------------------------------------------------

    def set_attr(self, name: str, v: _Val) -> None:
        """``EvalContext.set_attr``: the value in the attribute's type, and
        the memo's reads of it and every node with operands forgotten."""
        ref = self.particle.get(name)
        if ref is None:
            raise Unsupported(f"a write of attribute {name!r}, which the pool does not hold")
        if v.kind != ref.kind:
            raise Unsupported(f"a {v.kind} value written to the {ref.kind} attribute {name!r}")
        if v.lanes != ref.lanes:
            raise Unsupported(f"a {v.lanes}-lane value written to the {ref.lanes}-lane {name!r}")
        self.particle[name] = _Val(ref.kind, tuple(self.tmp(ref.kind, c) for c in v.comps),
                                   ref.vec)
        for h in list(self.memo):
            e = self.module.get(h)
            if (e.kind == "attribute" and e.name == name) or e.args:
                del self.memo[h]

    def draw(self, vt) -> _Val:
        """``EvalContext.draw``: the PCG draws of one rand value."""
        kind, lanes = _kind_lanes(vt)
        if kind != "f32":
            comps = []
            for _ in range(lanes):  # one integer draw a lane
                self.stmt("seed = pcg_hash(seed);")
                comps.append(self.tmp(kind, {"u32": "pcg_hash(seed)",
                                             "i32": "int32_t(pcg_hash(seed))",
                                             "bool": "(to_float01(pcg_hash(seed)) < 0.5f)"}[kind]))
            return _Val(kind, tuple(comps), lanes > 1)
        return self.frand(lanes, vec=isinstance(vt, VectorType))

    def frand(self, count: int, vec: bool) -> _Val:
        """``rng.rand_vec``: ``count`` uniform floats, the seed advanced."""
        if count == 1:
            self.stmt("seed = pcg_hash(seed);")
            return self.val("f32", ["to_float01(pcg_hash(seed))"], vec)
        if count in (2, 3):
            hs = []
            for _ in range(count):
                self.stmt("seed = pcg_hash(seed);")
                hs.append(self.tmp("u32", "seed"))
            return self.val("f32", [f"to_float01({h})" for h in hs], vec)
        r0 = self.tmp("u32", "pcg_hash(seed)")
        r1 = self.tmp("u32", f"pcg_hash({r0})")
        r2 = self.tmp("u32", f"pcg_hash({r1})")
        self.stmt(f"seed = {r2};")
        return self.val("f32", [
            f"to_float01({r0})",
            f"to_float01((({r0} & 0xFF000000u) >> 8) | ({r1} & 0x0000FFFFu))",
            f"to_float01((({r1} & 0xFFFF0000u) >> 8) | ({r2} & 0x000000FFu))",
            f"to_float01({r2} >> 8)",
        ], vec)

    def eval(self, h: int) -> _Val:
        if h in self.memo:
            return self.memo[h]
        out = self._eval(h)
        self.memo[h] = out
        return out

    def eval_f32(self, h: int, lanes: Optional[int] = None) -> _Val:
        v = self.eval(h)
        if v.kind != "f32" or (lanes is not None and v.lanes != lanes):
            want = "f32" if lanes is None else f"{lanes}-lane f32"
            raise Unsupported(f"expression {h} is {v.kind} x{v.lanes}, the emitter takes {want}")
        return v

    # -- nodes -----------------------------------------------------------

    def _eval(self, h: int) -> _Val:
        e = self.module.get(h)
        if e.kind == "literal":
            kind, lanes = _kind_lanes(e.value.value_type)
            vals = np.asarray(e.value.to_numpy()).reshape(-1)
            return _Val(kind, tuple(_c_literal(kind, x) for x in vals), lanes > 1)
        if e.kind == "attribute":
            if e.name == "id":
                return _Val("u32", ("slot",), False)
            if e.name not in self.particle:
                raise Unsupported(f"a read of attribute {e.name!r}, which the pool does not hold")
            return self.particle[e.name]
        if e.kind == "property":
            return self.gen.property(e.name)
        if e.kind == "builtin":
            return self._builtin(e)
        if e.kind == "cast":
            return self._cast(self.eval(e.args[0]), _kind_lanes(e.target_type)[0])
        if e.kind == "unary":
            return self._unary(e)
        if e.kind == "binary":
            return self._binary(e)
        if e.kind == "ternary":
            return self._ternary(e)
        raise Unsupported(f"expression node {h} of kind {e.kind!r}")

    def _builtin(self, e) -> _Val:
        op = e.builtin
        if op is BuiltInOp.RAND:
            return self.draw(e.rand_type)
        if op is BuiltInOp.IS_ALIVE:
            if self.context != "update":
                raise Unsupported("is_alive outside the update pass")
            return _Val("bool", (self.tmp("bool", "alive"),), False)
        if op is BuiltInOp.PARTICLE_INDEX:
            return _Val("u32", ("slot",), False)
        if op in FRAME_SCALARS:
            return _Val("f32", (f"f.{op.value}",), False)
        raise Unsupported(f"builtin {op.value!r}")

    def _cast(self, x: _Val, to: str) -> _Val:
        """``_eval``'s cast: a float to an integer saturates as XLA's
        ``convert`` (NaN to 0, the ends clamped), the rest as ``Tensor.to``."""
        if x.kind == to:
            return x
        out = []
        for c in x.comps:
            if x.kind == "f32" and to in ("i32", "u32"):
                out.append(f"sat_{to}({c})")
            elif to == "f32":
                out.append(f"float({c})" if x.kind != "bool" else f"({c} ? 1.0f : 0.0f)")
            elif to == "bool":
                out.append(f"({c} != 0)" if x.kind != "f32" else f"({c} != 0.0f)")
            elif to == "u32":
                out.append(f"uint32_t({c})")
            else:  # u32 / bool -> i32
                out.append(f"int32_t({c})")
        return self.val(to, out, x.vec)

    def _unary(self, e) -> _Val:
        op = e.op
        x = self.eval(e.args[0])
        fn = _UNARY_F32.get(op)
        if fn is not None:
            if x.kind != "f32":
                if op is UnaryOp.ABS and x.kind == "i32":
                    return self.val("i32", [f"abs_i32({c})" for c in x.comps], x.vec)
                raise Unsupported(f"unary {op.value} of {x.kind}")
            return self.val("f32", [fn.format(c) for c in x.comps], x.vec)
        if op in (UnaryOp.X, UnaryOp.Y, UnaryOp.Z, UnaryOp.W):
            idx = "xyzw".index(op.value)
            if not x.vec:
                if idx == 0:
                    return x
                raise Unsupported(f".{op.value} of a scalar")
            return _Val(x.kind, (x.comps[idx],), False)
        if op in (UnaryOp.ALL, UnaryOp.ANY):
            if x.kind != "bool":
                raise Unsupported(f"{op.value} of {x.kind}")
            joint = " && " if op is UnaryOp.ALL else " || "
            return self.val("bool", ["(" + joint.join(x.comps) + ")"], False)
        if x.kind != "f32":
            raise Unsupported(f"unary {op.value} of {x.kind}")
        if op is UnaryOp.LENGTH:
            if not x.vec:
                return self.val("f32", [f"fabsf({x.comps[0]})"], False)
            sq = [self.tmp("f32", f"{c} * {c}") for c in x.comps]
            return self.val("f32", [f"sqrtf({_sum_lanes(sq)})"], False)
        if op is UnaryOp.NORMALIZE:
            if not x.vec:
                # the eager sum over dim -1 of a batched scalar runs across lanes
                raise Unsupported("normalize of a scalar")
            sq = [self.tmp("f32", f"{c} * {c}") for c in x.comps]
            norm = self.tmp("f32", f"sqrtf({_sum_lanes(sq)})")
            return self.val("f32", [f"{c} / {norm}" for c in x.comps], x.vec)
        raise Unsupported(f"unary {op.value}")

    @staticmethod
    def _bcast(a: _Val, b: _Val) -> Tuple[List[str], List[str], bool]:
        """The lanes of two operands broadcast against each other."""
        n = max(a.lanes, b.lanes)
        for v in (a, b):
            if v.lanes not in (1, n):
                raise Unsupported(f"operands of {a.lanes} and {b.lanes} lanes")
        ac = list(a.comps) * (n // a.lanes)
        bc = list(b.comps) * (n // b.lanes)
        return ac, bc, a.vec or b.vec

    def _promote(self, a: _Val, b: _Val) -> Tuple[_Val, _Val]:
        """``compiler._promote``: int with float to float, int with uint to
        uint; a bool operand takes PyTorch's own promotion (not emitted)."""
        if a.kind == b.kind:
            return a, b
        if "bool" in (a.kind, b.kind):
            raise Unsupported(f"arithmetic on {a.kind} and {b.kind}")
        to = "f32" if "f32" in (a.kind, b.kind) else "u32" if "u32" in (a.kind, b.kind) else "i32"
        return self._cast(a, to), self._cast(b, to)

    def _binary(self, e) -> _Val:
        op = e.op
        lh, rh = e.args
        if op in (BinaryOp.UNIFORM_RAND, BinaryOp.NORMAL_RAND):
            a, b = self.eval_f32(lh), self.eval_f32(rh)
            vt = self.module.infer_type(lh if a.vec or not b.vec else rh)
            count = vt.count if isinstance(vt, VectorType) else 1
            ac, bc, vec = self._bcast(a, b)
            if len(ac) != count:
                raise Unsupported(f"a {count}-lane draw between {len(ac)}-lane bounds")
            if op is BinaryOp.UNIFORM_RAND:
                r = self.frand(count, vec)
                span = [self.tmp("f32", f"{y} - {x}") for x, y in zip(ac, bc)]
                prod = [self.tmp("f32", f"{rr} * {s}") for rr, s in zip(r.comps, span)]
                return self.val("f32", [f"{x} + {p}" for x, p in zip(ac, prod)], vec)
            u = self.frand(1, False)
            v = self.frand(count, vec)
            lg = self.tmp("f32", f"logf({u.comps[0]})")
            r = self.tmp("f32", f"sqrtf({c_float(-2.0)} * {lg})")
            out = []
            for m, s, vv in zip(ac, bc, v.comps):
                cs = self.tmp("f32", f"cosf({c_float(_TAU)} * {vv})")
                sr = self.tmp("f32", f"{s} * {r}")
                out.append(f"{m} + {self.tmp('f32', f'{sr} * {cs}')}")
            return self.val("f32", out, vec)

        a = self.eval(lh)
        b = self.eval(rh)
        if op is BinaryOp.VEC2:
            if a.kind != b.kind or a.vec or b.vec:
                raise Unsupported("vec2 of mixed or vector operands")
            return _Val(a.kind, a.comps + b.comps, True)
        if op is BinaryOp.VEC4_XYZ_W:
            if a.kind != "f32" or b.kind != "f32" or a.lanes != 3 or b.vec:
                raise Unsupported("vec4_xyz_w of other than a vec3 and a float")
            return _Val("f32", a.comps + b.comps, True)
        if op in (BinaryOp.DOT, BinaryOp.DISTANCE):
            if a.kind != "f32" or b.kind != "f32":
                raise Unsupported(f"{op.value} of {a.kind} and {b.kind}")
            ac, bc, vec = self._bcast(a, b)
            if op is BinaryOp.DOT:
                if not vec:
                    raise Unsupported("dot of scalars")
                p = [self.tmp("f32", f"{x} * {y}") for x, y in zip(ac, bc)]
                return self.val("f32", [_sum_lanes(p)], False)
            if a.vec != b.vec:
                raise Unsupported("distance between a scalar and a vector")
            d = [self.tmp("f32", f"{x} - {y}") for x, y in zip(ac, bc)]
            if not a.vec:
                return self.val("f32", [f"fabsf({d[0]})"], False)
            sq = [self.tmp("f32", f"{x} * {x}") for x in d]
            return self.val("f32", [f"sqrtf({_sum_lanes(sq)})"], False)
        if op is BinaryOp.CROSS:
            raise Unsupported("cross (ATen's kernel may contract to FMA)")

        a, b = self._promote(a, b)
        ac, bc, vec = self._bcast(a, b)
        k = a.kind
        if op in (BinaryOp.LT, BinaryOp.LE, BinaryOp.GT, BinaryOp.GE):
            sym = {BinaryOp.LT: "<", BinaryOp.LE: "<=", BinaryOp.GT: ">", BinaryOp.GE: ">="}[op]
            if k == "bool":
                raise Unsupported(f"{op.value} of bools")
            return self.val("bool", [f"({x} {sym} {y})" for x, y in zip(ac, bc)], vec)
        if op is BinaryOp.STEP:
            if k == "bool":
                raise Unsupported("step of bools")
            return self.val("f32", [f"(({y} < {x}) ? 0.0f : 1.0f)" for x, y in zip(ac, bc)], vec)
        if k == "bool":
            raise Unsupported(f"{op.value} of bools")
        if op in (BinaryOp.MIN, BinaryOp.MAX):
            if k == "f32":
                f = _fmin_nan if op is BinaryOp.MIN else _fmax_nan
                return self.val(k, [f(x, y) for x, y in zip(ac, bc)], vec)
            sym = "<" if op is BinaryOp.MIN else ">"
            return self.val(k, [f"(({x} {sym} {y}) ? {x} : {y})" for x, y in zip(ac, bc)], vec)
        if k == "f32":
            if op in (BinaryOp.ADD, BinaryOp.SUB, BinaryOp.MUL, BinaryOp.DIV):
                sym = {BinaryOp.ADD: "+", BinaryOp.SUB: "-", BinaryOp.MUL: "*",
                       BinaryOp.DIV: "/"}[op]
                return self.val(k, [f"{x} {sym} {y}" for x, y in zip(ac, bc)], vec)
            if op is BinaryOp.REM:
                return self.val(k, [f"fmodf({x}, {y})" for x, y in zip(ac, bc)], vec)
            if op is BinaryOp.ATAN2:
                return self.val(k, [f"atan2f({x}, {y})" for x, y in zip(ac, bc)], vec)
            raise Unsupported(f"binary {op.value} of floats")
        if op in (BinaryOp.ADD, BinaryOp.SUB, BinaryOp.MUL):
            # two's complement wrap, as the int32 / masked int64 tensors do
            sym = {BinaryOp.ADD: "+", BinaryOp.SUB: "-", BinaryOp.MUL: "*"}[op]
            exprs = [f"(uint32_t({x}) {sym} uint32_t({y}))" for x, y in zip(ac, bc)]
            if k == "i32":
                exprs = [f"int32_t({x})" for x in exprs]
            return self.val(k, exprs, vec)
        raise Unsupported(f"binary {op.value} of {k}")

    def _ternary(self, e) -> _Val:
        op = e.op
        a, b, c = (self.eval(h) for h in e.args)
        if op is TernaryOp.VEC3:
            if not (a.kind == b.kind == c.kind) or a.vec or b.vec or c.vec:
                raise Unsupported("vec3 of mixed or vector operands")
            return _Val(a.kind, a.comps + b.comps + c.comps, True)
        if not (a.kind == b.kind == c.kind == "f32"):
            raise Unsupported(f"{op.value} of {a.kind}, {b.kind}, {c.kind}")
        n = max(a.lanes, b.lanes, c.lanes)
        if any(v.lanes not in (1, n) for v in (a, b, c)):
            raise Unsupported(f"{op.value} of mismatched lanes")
        ac, bc, cc = (list(v.comps) * (n // v.lanes) for v in (a, b, c))
        vec = a.vec or b.vec or c.vec
        if op is TernaryOp.MIX:
            d = [self.tmp("f32", f"{y} - {x}") for x, y in zip(ac, bc)]
            p = [self.tmp("f32", f"{dd} * {t}") for dd, t in zip(d, cc)]
            return self.val("f32", [f"{x} + {pp}" for x, pp in zip(ac, p)], vec)
        if op is TernaryOp.CLAMP:
            lo = [self.tmp("f32", _fmax_nan(x, y)) for x, y in zip(ac, bc)]
            return self.val("f32", [_fmin_nan(x, y) for x, y in zip(lo, cc)], vec)
        if op is TernaryOp.SMOOTHSTEP:
            out = []
            for x0, x1, x in zip(ac, bc, cc):
                num = self.tmp("f32", f"{x} - {x0}")
                den = self.tmp("f32", f"{x1} - {x0}")
                t = self.tmp("f32", f"clamp_nan({num} / {den}, 0.0f, 1.0f)")
                tt = self.tmp("f32", f"{t} * {t}")
                two = self.tmp("f32", f"{t} * 2.0f")
                out.append(f"{tt} * (3.0f - {two})")
            return self.val("f32", out, vec)
        raise Unsupported(f"ternary {op.value}")


# f32 unary ops: the CUDA function ATen's kernel calls for each
_UNARY_F32 = {
    UnaryOp.ABS: "fabsf({})",
    UnaryOp.ACOS: "acosf({})",
    UnaryOp.ASIN: "asinf({})",
    UnaryOp.ATAN: "atanf({})",
    UnaryOp.CEIL: "ceilf({})",
    UnaryOp.COS: "cosf({})",
    UnaryOp.EXP: "expf({})",
    UnaryOp.EXP2: "exp2f({})",
    UnaryOp.FLOOR: "floorf({})",
    UnaryOp.LOG: "logf({})",
    UnaryOp.LOG2: "log2f({})",
    UnaryOp.SIGN: "sign_f32({})",
    UnaryOp.SIN: "sinf({})",
    UnaryOp.SQRT: "sqrtf({})",
    UnaryOp.TAN: "tanf({})",
    UnaryOp.FRACT: "({0} - floorf({0}))",
    UnaryOp.INV_SQRT: "(1.0f / sqrtf({}))",
    UnaryOp.ROUND: "nearbyintf({})",
    UnaryOp.SATURATE: "clamp_nan({}, 0.0f, 1.0f)",
}


# ---------------------------------------------------------------------------
# modifiers: each restates its ``apply`` (modifiers/*.py) op for op


def _set_attribute(p: _Pass, m) -> None:
    p.set_attr(m.attribute, p.eval(m.value))


def _position_sphere(p: _Pass, m) -> None:
    from .modifiers.base import ShapeDimension

    c = p.eval_f32(m.center, 3)
    if m.dimension is ShapeDimension.VOLUME:
        u = p.frand(1, False).comps[0]
        root = p.tmp("f32", f"powf({u}, {c_float(1.0 / 3.0)})")
        r = p.tmp("f32", f"{root} * {p.eval_f32(m.radius, 1).comps[0]}")
    else:
        r = p.eval_f32(m.radius, 1).comps[0]
    theta = p.tmp("f32", f"{p.frand(1, False).comps[0]} * {c_float(_TAU)}")
    z2 = p.tmp("f32", f"{p.frand(1, False).comps[0]} * 2.0f")
    z = p.tmp("f32", f"{z2} - 1.0f")
    zz = p.tmp("f32", f"{z} * {z}")
    one = p.tmp("f32", f"1.0f - {zz}")
    sinphi = p.tmp("f32", f"sqrtf({_fmax_nan(one, '0.0f')})")
    direction = [p.tmp("f32", f"{sinphi} * cosf({theta})"),
                 p.tmp("f32", f"{sinphi} * sinf({theta})"), z]
    rd = [p.tmp("f32", f"{r} * {d}") for d in direction]
    p.set_attr("position", p.val("f32", [f"{cc} + {x}" for cc, x in zip(c.comps, rd)], True))


def _normalize_safe(p: _Pass, v: List[str]) -> List[str]:
    """``modifiers/velocity.py::_normalize``: ``v * rsqrt(max(|v|^2, 1e-24))``."""
    sq = [p.tmp("f32", f"{x} * {x}") for x in v]
    s = p.tmp("f32", _sum_lanes(sq))
    inv = p.tmp("f32", f"rsqrtf({_fmax_nan(s, c_float(1e-24))})")
    return [p.tmp("f32", f"{x} * {inv}") for x in v]


def _velocity_sphere(p: _Pass, m) -> None:
    center = p.eval_f32(m.center, 3)
    speed = p.eval_f32(m.speed, 1).comps[0]
    pos = p.particle.get("position")
    if pos is None:
        raise Unsupported("SetVelocitySphereModifier without a position")
    delta = [p.tmp("f32", f"{x} - {c}") for x, c in zip(pos.comps, center.comps)]
    direction = _normalize_safe(p, delta)
    p.set_attr("velocity", p.val("f32", [f"{d} * {speed}" for d in direction], True))


def _accel(p: _Pass, m) -> None:
    a = p.eval_f32(m.accel, 3)
    v = p.particle["velocity"]
    adt = [p.tmp("f32", f"{x} * f.delta_time") for x in a.comps]
    p.set_attr("velocity", p.val("f32", [f"{x} + {y}" for x, y in zip(v.comps, adt)], True))


def _linear_drag(p: _Pass, m) -> None:
    drag = p.eval_f32(m.drag, 1).comps[0]
    ddt = p.tmp("f32", f"{drag} * f.delta_time")
    one = p.tmp("f32", f"1.0f - {ddt}")
    factor = p.tmp("f32", _fmax_nan(one, "0.0f"))
    v = p.particle["velocity"]
    p.set_attr("velocity", p.val("f32", [f"{x} * {factor}" for x in v.comps], True))


def _emitters():
    """Modifier class -> (emitter, the passes it may run in)."""
    from .modifiers.accel import AccelModifier
    from .modifiers.attr import SetAttributeModifier
    from .modifiers.force import LinearDragModifier
    from .modifiers.position import SetPositionSphereModifier
    from .modifiers.velocity import SetVelocitySphereModifier

    return {
        SetAttributeModifier: (_set_attribute, ("init", "update")),
        SetPositionSphereModifier: (_position_sphere, ("init", "update")),
        SetVelocitySphereModifier: (_velocity_sphere, ("init", "update")),
        AccelModifier: (_accel, ("update",)),
        LinearDragModifier: (_linear_drag, ("update",)),
    }


# ---------------------------------------------------------------------------
# the generator


class _Generator:
    def __init__(self, asset: EffectAsset):
        self.asset = asset
        layout = asset.particle_layout()
        if layout.contains("particle_counter"):
            raise Unsupported("PARTICLE_COUNTER (it reads the counter before the step's update)")
        fields = []
        for a in layout.storage_attributes():
            kind, lanes = _kind_lanes(a.value_type)
            if kind != "f32" and lanes != 1:
                raise Unsupported(f"attribute {a.name!r}: a vector of {kind}")
            fields.append(Field(a.name, kind, lanes))
        self.fields = tuple(fields)
        self.defaults = {a.name: np.asarray(a.default_numpy()).reshape(-1)
                         for a in layout.storage_attributes()}
        self.global_space = asset.simulation_space is SimulationSpace.GLOBAL
        offset = HEADER_WORDS + (12 if self.global_space else 0)
        props = []
        for name, value in asset.module.properties().items():
            kind, lanes = _kind_lanes(value.value_type)
            props.append(PropertySlot(name, kind, lanes, offset, _words_of(kind, value.to_numpy())))
            offset += lanes
        self.properties = tuple(props)
        self.words = offset

    def property(self, name: str) -> _Val:
        for s in self.properties:
            if s.name == name:
                dec = {"f32": "bits_f({})", "i32": "int32_t({})", "u32": "{}",
                       "bool": "({} != 0u)"}[s.kind]
                return _Val(s.kind, tuple(dec.format(f"w[{s.offset + j}]") for j in range(s.lanes)),
                            s.lanes > 1)
        raise Unsupported(f"property {name!r} is not declared")

    def _lane_vals(self) -> Dict[str, _Val]:
        return {fd.name: _Val(fd.kind, tuple(f"l.a_{fd.name}[{j}]" for j in range(fd.lanes))
                              if fd.lanes > 1 else (f"l.a_{fd.name}",), fd.lanes > 1)
                for fd in self.fields}

    def _run(self, p: _Pass, modifiers) -> None:
        emitters = _emitters()
        for m in modifiers:
            emit = emitters.get(type(m))
            if emit is None or p.context not in emit[1]:
                raise Unsupported(f"{p.context} modifier {type(m).__name__} has no emitter")
            emit[0](p, m)

    def spawn_body(self) -> List[str]:
        """The init pass of one spawned lane: defaults, the init modifiers,
        the emitter transform, then the lane's new state."""
        p = _Pass(self, "init", {})
        p.stmt("uint32_t seed = pcg_hash(rank ^ w[1]);")
        for fd in self.fields:
            comps = tuple(_c_literal(fd.kind, x) for x in self.defaults[fd.name])
            p.particle[fd.name] = _Val(fd.kind, comps, fd.lanes > 1)
        self._run(p, self.asset.init_modifiers)
        if self.global_space:
            # ops/linalg.py affine3 / rotate3: ((x r0 + y r1) + z r2) (+ t)
            for name in ("position", "velocity"):
                v = p.particle.get(name)
                if v is None:
                    continue
                out = []
                for r in range(3):
                    terms = [p.tmp("f32", f"{v.comps[c]} * bits_f(w[{2 + 4 * r + c}])")
                             for c in range(3)]
                    s = p.tmp("f32", f"{terms[0]} + {terms[1]}")
                    s = f"{s} + {terms[2]}"
                    if name == "position":
                        s = f"{p.tmp('f32', s)} + bits_f(w[{2 + 4 * r + 3}])"
                    out.append(s)
                p.particle[name] = p.val("f32", out, True)
        for fd in self.fields:
            for j, c in enumerate(p.particle[fd.name].comps):
                p.stmt(f"l.a_{fd.name}{f'[{j}]' if fd.lanes > 1 else ''} = {c};")
        p.stmt("l.seed = seed;")
        p.stmt("l.alive = true;")
        return p.lines

    def update_body(self) -> List[str]:
        """The update pass of one lane (every lane, as the eager pass)."""
        p = _Pass(self, "update", {})
        for fd in self.fields:
            p.particle[fd.name] = p.val(fd.kind, self._lane_vals()[fd.name].comps, fd.lanes > 1)
        p.stmt("uint32_t seed = l.seed;")
        p.stmt("bool alive = l.alive;")
        has = {fd.name: fd for fd in self.fields}
        if "age" in has:
            if has["age"].kind != "f32":
                raise Unsupported("a non-float age")
            p.particle["age"] = p.val("f32", [f"{p.particle['age'].comps[0]} + f.delta_time"],
                                      False)
            if "lifetime" in has:
                p.stmt(f"alive = alive && ({p.particle['age'].comps[0]} < "
                       f"{p.particle['lifetime'].comps[0]});")
        mi = self.asset.motion_integration
        integrate = mi is not MotionIntegration.NONE and "velocity" in has

        def integrate_now():
            pos, vel = p.particle["position"], p.particle["velocity"]
            vdt = [p.tmp("f32", f"{v} * f.delta_time") for v in vel.comps]
            p.particle["position"] = p.val("f32", [f"{x} + {y}" for x, y in zip(pos.comps, vdt)],
                                           True)

        if integrate and mi is MotionIntegration.PRE_UPDATE:
            integrate_now()
        self._run(p, self.asset.update_modifiers)
        if integrate and mi is MotionIntegration.POST_UPDATE:
            integrate_now()
        for fd in self.fields:
            for j, c in enumerate(p.particle[fd.name].comps):
                p.stmt(f"l.a_{fd.name}{f'[{j}]' if fd.lanes > 1 else ''} = {c};")
        p.stmt("l.seed = seed;")
        p.stmt("l.alive = alive;")
        return p.lines


def generate(asset: EffectAsset) -> StepSource:
    """The step of ``asset`` as CUDA C++ (:mod:`runtime/fused.py`'s kernel
    around its per-lane functions). Raises :class:`Unsupported`."""
    gen = _Generator(asset)
    text = render_source(asset.name, gen.fields, gen.words, gen.spawn_body(), gen.update_body())
    return StepSource(text, gen.fields, gen.properties, gen.words, gen.global_space)


def try_generate(asset: EffectAsset, consumes_events: bool = False, sharded: bool = False
                 ) -> Tuple[Optional[StepSource], Optional[str]]:
    """``(source, None)`` when an effect of ``asset`` steps through the
    generated kernel, else ``(None, why)``: GPU events, a mesh, or anything
    without an emitter."""
    if asset.num_event_channels():
        return None, "it emits GPU spawn events"
    if consumes_events:
        return None, "it consumes GPU spawn events"
    if sharded:
        return None, "its pool is sharded over a mesh"
    try:
        return generate(asset), None
    except Unsupported as exc:
        return None, str(exc)


def fuse_reason(asset: EffectAsset, consumes_events: bool = False, sharded: bool = False
                ) -> Optional[str]:
    """Why an effect of ``asset`` keeps the eager step, or None
    (:func:`try_generate`)."""
    return try_generate(asset, consumes_events, sharded)[1]


# ---------------------------------------------------------------------------
# the source: helpers, the lane's functions, the kernels and their launcher

_PTR = {"f32": "float", "i32": "int32_t", "u32": "long long", "bool": "unsigned char"}

_HEAD = r"""// Generated by bevy_hanabi_tpu_torch/codegen.py from effect "{name}": one
// frame of its particle step in one pass over the pool (runtime/fused.py
// builds and launches it). It replaces no TPU kernel: the JAX package's step
// (bevy_hanabi_tpu/runtime/effect.py:518-695) was XLA's fusion of the same
// graph. Its bound is bytes: every lane's attributes, alive flag and seed
// are read and written once. Each thread moves four neighbouring lanes with
// 16-byte loads and stores where the pool's layout allows; the dead lanes
// are ranked by one scan of the block, and an instance of more than 4096
// lanes gets a count pass and a scan of its tiles' counts first. Built with
// -fmad=false and IEEE division and square root, so every operation rounds
// as the ATen kernel of the eager step that computes it.
#include <stdint.h>
#include <string.h>
#include <math.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#define HD static inline
static inline float rsqrtf(float x) {{ return 1.0f / sqrtf(x); }}  // a host build's stand-in
#endif

constexpr int W = {words};  // an instance's words: count, frame hash, [transform], properties

HD float bits_f(uint32_t u) {{
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}}
// ops/rng.py's PCG, in native uint32
HD uint32_t pcg_hash(uint32_t x) {{
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}}
HD float to_float01(uint32_t u) {{ return bits_f((u & 0x007FFFFFu) | 0x3F800000u) - 1.0f; }}
// ATen's maximum, minimum and clamp on floats: a NaN operand propagates
HD float max_nan(float a, float b) {{ return a != a ? a : (b != b ? b : fmaxf(a, b)); }}
HD float min_nan(float a, float b) {{ return a != a ? a : (b != b ? b : fminf(a, b)); }}
HD float clamp_nan(float x, float lo, float hi) {{ return x != x ? x : fminf(fmaxf(x, lo), hi); }}
HD float sign_f32(float a) {{ return float((0.0f < a) - (a < 0.0f)); }}
HD int32_t abs_i32(int32_t x) {{ return x < 0 ? int32_t(0u - uint32_t(x)) : x; }}
// compiler.py::_saturating_int: NaN to 0, clamped in float, truncated
HD int32_t sat_i32(float x) {{
  const float c = fminf(fmaxf(x != x ? 0.0f : x, -2147483648.0f), 2147483648.0f);
  const long long v = (long long)c;
  return int32_t(v > 2147483647LL ? 2147483647LL : v);
}}
HD uint32_t sat_u32(float x) {{
  const float c = fminf(fmaxf(x != x ? 0.0f : x, 0.0f), 4294967296.0f);
  const long long v = (long long)c;
  return uint32_t(v > 4294967295LL ? 4294967295LL : v);
}}

struct Lane {{  // an attribute NAME is the field a_NAME
{lane_fields}
  uint32_t seed;
  bool alive;
}};
struct Pool {{
{pool_fields}
  unsigned char* alive;
  long long* seed;     // uint32 values
  long long* counter;  // [instances], uint32 values
}};
struct Frame {{
  float time, delta_time, virtual_time, virtual_delta_time, real_time, real_delta_time;
  int32_t k;          // the frame's row of a group's staged words
  int32_t instances;
  uint32_t w[W];      // a single effect's words
}};

static inline Pool make_pool(void* const* ptrs) {{
  Pool p;
{make_pool}
  p.alive = (unsigned char*)ptrs[{n_fields}];
  p.seed = (long long*)ptrs[{n_fields} + 1];
  p.counter = (long long*)ptrs[{n_fields} + 2];
  return p;
}}

HD void load_lane(const Pool& p, long long i, Lane& l) {{
{load_lane}
  l.seed = uint32_t(p.seed[i]);
  l.alive = p.alive[i] != 0;
}}
HD void store_lane(const Pool& p, long long i, const Lane& l) {{
{store_lane}
  p.seed[i] = (long long)l.seed;
  p.alive[i] = l.alive ? 1 : 0;
}}

// The init pass of a spawned lane: its rank among the dead lanes seeds it.
HD void spawn_lane(Lane& l, uint32_t slot, uint32_t rank, const Frame& f, const uint32_t* w) {{
  (void)slot; (void)f;
{spawn}
}}

// The update pass, on every lane as the eager pass updates every lane.
HD void update_lane(Lane& l, uint32_t slot, const Frame& f, const uint32_t* w) {{
  (void)slot; (void)w;
{update}
}}
"""

_KERNELS = r"""
#ifdef __CUDACC__
constexpr int LPT = 4;  // lanes a thread

// four lanes from i (a multiple of 4), 16 bytes a load
__device__ __forceinline__ void load4(const Pool& p, long long i, Lane (&l)[LPT]) {{
{load4}
  const longlong2* sd = reinterpret_cast<const longlong2*>(p.seed + i);
  const longlong2 s0 = sd[0], s1 = sd[1];
  l[0].seed = uint32_t(s0.x); l[1].seed = uint32_t(s0.y);
  l[2].seed = uint32_t(s1.x); l[3].seed = uint32_t(s1.y);
  const uint32_t al = *reinterpret_cast<const uint32_t*>(p.alive + i);
#pragma unroll
  for (int q = 0; q < LPT; ++q) l[q].alive = ((al >> (8 * q)) & 0xFFu) != 0;
}}
__device__ __forceinline__ void store4(const Pool& p, long long i, const Lane (&l)[LPT]) {{
{store4}
  longlong2* sd = reinterpret_cast<longlong2*>(p.seed + i);
  sd[0] = make_longlong2((long long)l[0].seed, (long long)l[1].seed);
  sd[1] = make_longlong2((long long)l[2].seed, (long long)l[3].seed);
  uint32_t al = 0;
#pragma unroll
  for (int q = 0; q < LPT; ++q) al |= (l[q].alive ? 1u : 0u) << (8 * q);
  *reinterpret_cast<uint32_t*>(p.alive + i) = al;
}}

// exclusive prefix sum over the block (blockDim.x a multiple of 32), and the total
__device__ __forceinline__ int block_scan(int v, int& total) {{
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {{
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }}
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {{
    int s = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {{
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }}
    sums[lane] = s;
  }}
  __syncthreads();
  total = sums[warps - 1];
  const int before = warp ? sums[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}}

__device__ __forceinline__ void instance_words(const Frame& f, const uint32_t* staged, int inst,
                                               uint32_t (&w)[W]) {{
  if (staged) {{
    const uint32_t* src = staged + ((long long)f.k * f.instances + inst) * W;
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = src[j];
  }} else {{
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = f.w[j];
  }}
}}

// the instance's counter advances by its spawns: min(requested, dead lanes)
__device__ __forceinline__ void advance_counter(const Pool& p, int inst, int requested, int dead) {{
  const long long spawned = requested < dead ? requested : dead;
  p.counter[inst] = (p.counter[inst] + spawned) & 0xFFFFFFFFLL;
}}

// One tile of blockDim.x * 4 lanes of one instance a block. tile_base holds
// the dead lanes of the instance's earlier tiles (null: one tile an instance).
template <int MAXT>
__global__ void __launch_bounds__(MAXT) hanabi_step_kernel(Pool p, Frame f, const uint32_t* staged,
                                                           const int* tile_base, long long per,
                                                           int tpi) {{
  const int tile = blockIdx.x, inst = tile / tpi, tin = tile - inst * tpi;
  const long long first = (long long)inst * per, end = first + per;
  const long long lo = first + (long long)tin * blockDim.x * LPT + (long long)threadIdx.x * LPT;
  const int nl = lo >= end ? 0 : (end - lo >= LPT ? LPT : int(end - lo));
  uint32_t w[W];
  instance_words(f, staged, inst, w);
  Lane l[LPT];
  const bool vec = nl == LPT && (lo & 3) == 0;
  if (vec) {{
    load4(p, lo, l);
  }} else {{
#pragma unroll
    for (int q = 0; q < LPT; ++q)
      if (q < nl) load_lane(p, lo + q, l[q]);
  }}
  int dead = 0;
#pragma unroll
  for (int q = 0; q < LPT; ++q) dead += (q < nl && !l[q].alive) ? 1 : 0;
  int total;
  int rank = block_scan(dead, total);
  const int requested = int(w[0]);
  if (tile_base) {{
    rank += tile_base[tile];
  }} else if (threadIdx.x == 0) {{
    advance_counter(p, inst, requested, total);
  }}
#pragma unroll
  for (int q = 0; q < LPT; ++q) {{
    if (q < nl) {{
      const uint32_t slot = uint32_t(lo + q - first);
      if (!l[q].alive) {{
        if (rank < requested) spawn_lane(l[q], slot, uint32_t(rank), f, w);
        ++rank;
      }}
      update_lane(l[q], slot, f, w);
    }}
  }}
  if (vec) {{
    store4(p, lo, l);
  }} else {{
#pragma unroll
    for (int q = 0; q < LPT; ++q)
      if (q < nl) store_lane(p, lo + q, l[q]);
  }}
}}

// Dead lanes of each tile of 1024 lanes (an instance of more than 4096 lanes).
__global__ void __launch_bounds__(256) hanabi_step_count_kernel(const unsigned char* alive,
                                                                int* tile_dead, long long per,
                                                                int tpi) {{
  const int tile = blockIdx.x, inst = tile / tpi, tin = tile - inst * tpi;
  const long long first = (long long)inst * per, end = first + per;
  const long long lo = first + (long long)tin * blockDim.x * LPT + (long long)threadIdx.x * LPT;
  int dead = 0;
  if (end - lo >= LPT && (lo & 3) == 0) {{
    const uint32_t a = *reinterpret_cast<const uint32_t*>(alive + lo);
#pragma unroll
    for (int q = 0; q < LPT; ++q) dead += ((a >> (8 * q)) & 0xFFu) ? 0 : 1;
  }} else {{
    for (long long i = lo; i < end && i < lo + LPT; ++i) dead += alive[i] ? 0 : 1;
  }}
  int total;
  block_scan(dead, total);
  if (threadIdx.x == 0) tile_dead[tile] = total;
}}

// Each instance's tile counts to exclusive prefixes, in place; its counter.
__global__ void __launch_bounds__(1024) hanabi_step_scan_kernel(Pool p, Frame f,
                                                                const uint32_t* staged,
                                                                int* tile_dead, int tpi) {{
  const int inst = blockIdx.x;
  int* t = tile_dead + (long long)inst * tpi;
  int carry = 0;
  for (int j0 = 0; j0 < tpi; j0 += blockDim.x) {{
    const int j = j0 + threadIdx.x;
    const int v = j < tpi ? t[j] : 0;
    int total;
    const int before = block_scan(v, total);
    if (j < tpi) t[j] = carry + before;
    carry += total;
  }}
  if (threadIdx.x == 0) {{
    const int requested = int(staged ? staged[((long long)f.k * f.instances + inst) * W] : f.w[0]);
    advance_counter(p, inst, requested, carry);
  }}
}}

static int tiles_per_instance(long long per) {{
  return per <= 4096 ? 1 : int((per + 1023) / 1024);
}}

extern "C" int hanabi_step_scratch(int instances, long long per) {{
  return per <= 4096 ? 0 : instances * tiles_per_instance(per);
}}

// ptrs: the fields' arrays in order, then alive, seed, counter. frame: a
// struct Frame's words. staged: a group's [K, I, W] words, or null. scratch:
// hanabi_step_scratch(instances, per) ints. Returns the kernels launched, or
// minus the CUDA error.
extern "C" int hanabi_step_launch(void* const* ptrs, const uint32_t* frame, const uint32_t* staged,
                                  int* scratch, int instances, long long per, void* stream) {{
  const Pool p = make_pool(ptrs);
  Frame f;
  memcpy(&f, frame, sizeof(Frame));
  cudaStream_t s = (cudaStream_t)stream;
  if (instances <= 0 || per <= 0) return 0;
  int kernels;
  if (per <= 4096) {{
    kernels = 1;
    const long long quads = (per + LPT - 1) / LPT;
    int threads = 32;
    while (threads < quads) threads <<= 1;
    if (threads <= 256)
      hanabi_step_kernel<256><<<instances, threads, 0, s>>>(p, f, staged, nullptr, per, 1);
    else
      hanabi_step_kernel<1024><<<instances, threads, 0, s>>>(p, f, staged, nullptr, per, 1);
  }} else {{
    kernels = 3;
    const int tpi = tiles_per_instance(per);
    const unsigned tiles = (unsigned)instances * (unsigned)tpi;
    hanabi_step_count_kernel<<<tiles, 256, 0, s>>>(p.alive, scratch, per, tpi);
    hanabi_step_scan_kernel<<<instances, 1024, 0, s>>>(p, f, staged, scratch, tpi);
    hanabi_step_kernel<256><<<tiles, 256, 0, s>>>(p, f, staged, scratch, per, tpi);
  }}
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? kernels : -(int)err;
}}

extern "C" const char* hanabi_step_error_string(int code) {{
  return cudaGetErrorString((cudaError_t)code);
}}
#endif
"""


def _vec_io(fd: Field) -> Tuple[List[str], List[str]]:
    """The 16-byte loads and stores of one field over four lanes."""
    f = f"a_{fd.name}"
    if fd.kind == "f32":
        n = fd.lanes  # four lanes of ``n`` floats: ``n`` float4s
        src = f"p.{f} + {n} * i" if n > 1 else f"p.{f} + i"
        elems = [f"l[{q}].{f}" + (f"[{j}]" if n > 1 else "") for q in range(4) for j in range(n)]
        comp = [f"t{e // 4}.{'xyzw'[e % 4]}" for e in range(4 * n)]
        ld = [f"  {{ const float4* s = reinterpret_cast<const float4*>({src});",
              "    const float4 " + ", ".join(f"t{k} = s[{k}]" for k in range(n)) + ";"]
        ld += [f"    {d} = {c};" for d, c in zip(elems, comp)] + ["  }"]
        st = [f"  {{ float4* s = reinterpret_cast<float4*>({src});"]
        st += [f"    s[{k}] = make_float4({', '.join(elems[4 * k:4 * k + 4])});" for k in range(n)]
        return ld, st + ["  }"]
    if fd.kind == "i32":
        return ([f"  {{ const int4 t = *reinterpret_cast<const int4*>(p.{f} + i); "
                 f"l[0].{f} = t.x; l[1].{f} = t.y; l[2].{f} = t.z; l[3].{f} = t.w; }}"],
                [f"  *reinterpret_cast<int4*>(p.{f} + i) = "
                 f"make_int4(l[0].{f}, l[1].{f}, l[2].{f}, l[3].{f});"])
    if fd.kind == "u32":
        return ([f"  {{ const longlong2* s = reinterpret_cast<const longlong2*>(p.{f} + i); "
                 f"const longlong2 a = s[0], b = s[1]; l[0].{f} = uint32_t(a.x); "
                 f"l[1].{f} = uint32_t(a.y); l[2].{f} = uint32_t(b.x); "
                 f"l[3].{f} = uint32_t(b.y); }}"],
                [f"  {{ longlong2* s = reinterpret_cast<longlong2*>(p.{f} + i); "
                 f"s[0] = make_longlong2(l[0].{f}, l[1].{f}); "
                 f"s[1] = make_longlong2(l[2].{f}, l[3].{f}); }}"])
    return ([f"  {{ const uint32_t a = *reinterpret_cast<const uint32_t*>(p.{f} + i);"]
            + [f"    l[{q}].{f} = ((a >> {8 * q}) & 0xFFu) != 0;" for q in range(4)] + ["  }"],
            [f"  *reinterpret_cast<uint32_t*>(p.{f} + i) = "
             + " | ".join(f"(l[{q}].{f} ? {1 << (8 * q)}u : 0u)" for q in range(4)) + ";"])


def render_source(name: str, fields, words: int, spawn: List[str], update: List[str]) -> str:
    """The whole source of an effect's step around its two lane functions."""
    lane_fields, pool_fields, make_pool, load, store, load4, store4 = [], [], [], [], [], [], []
    for k, fd in enumerate(fields):
        ct = _CTYPE[fd.kind]
        f = f"a_{fd.name}"
        lane_fields.append(f"  {ct} {f}" + (f"[{fd.lanes}];" if fd.lanes > 1 else ";"))
        pool_fields.append(f"  {_PTR[fd.kind]}* {f};")
        make_pool.append(f"  p.{f} = ({_PTR[fd.kind]}*)ptrs[{k}];")
        for j in range(fd.lanes):
            idx = f"{fd.lanes} * i + {j}" if fd.lanes > 1 else "i"
            dst = f"l.{f}" + (f"[{j}]" if fd.lanes > 1 else "")
            get = {"f32": "{}", "i32": "{}", "u32": "uint32_t({})", "bool": "({} != 0)"}[fd.kind]
            put = {"f32": "{}", "i32": "{}", "u32": "(long long){}",
                   "bool": "({} ? 1 : 0)"}[fd.kind]
            load.append(f"  {dst} = {get.format(f'p.{f}[{idx}]')};")
            store.append(f"  p.{f}[{idx}] = {put.format(dst)};")
        ld, st = _vec_io(fd)
        load4 += ld
        store4 += st
    head = _HEAD.format(
        name=name.replace("\\", "\\\\").replace('"', '\\"').replace("\n", " "),
        words=words, n_fields=len(fields),
        lane_fields="\n".join(lane_fields), pool_fields="\n".join(pool_fields),
        make_pool="\n".join(make_pool), load_lane="\n".join(load), store_lane="\n".join(store),
        spawn="\n".join("  " + s for s in spawn), update="\n".join("  " + s for s in update),
    )
    return head + _KERNELS.format(load4="\n".join(load4), store4="\n".join(store4))
