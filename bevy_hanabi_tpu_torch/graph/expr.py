"""Effect expression graph.

TPU-native re-design of ``bevy_hanabi/src/graph/expr.rs``. The reference
builds an arena (``Module``) of ``Expr`` nodes and *compiles them to WGSL
source strings*; pipelines are then specialized per generated shader. Here the
same arena exists with the same operator vocabulary, but "compilation" is
**tracing**: the evaluator in :mod:`bevy_hanabi_tpu.compiler` walks the graph
inside ``jax.jit`` and returns JAX arrays, so XLA plays the role of both the
shader compiler and the pipeline cache. Common-subexpression caching
(reference: modifier/mod.rs:309-319) falls out of handle-level memoization +
XLA CSE; side-effecting expressions (the ``rand`` family) memoize too —
the reference stores them in a local shader var so a reused handle sees ONE
draw, never a duplicate side-effect (graph/expr.rs:1044-1064). Independent
draws require distinct handles.

Handles are 1-based integers, mirroring the reference's ``NonZeroU32``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from ..attributes import Attribute
from ..values import (
    BOOL,
    FLOAT,
    INT,
    UINT,
    ScalarType,
    Value,
    ValueType,
    VectorType,
    as_value,
    value_type_from_str,
    value_type_to_str,
)

__all__ = [
    "ExprHandle",
    "Expr",
    "Module",
    "UnaryOp",
    "BinaryOp",
    "TernaryOp",
    "BuiltInOp",
    "ExprWriter",
    "WriterExpr",
]

ExprHandle = int  # 1-based index into Module._exprs


class UnaryOp(enum.Enum):
    """Unary operators (reference: graph/expr.rs:1832+)."""

    ABS = "abs"
    ACOS = "acos"
    ASIN = "asin"
    ATAN = "atan"
    ALL = "all"
    ANY = "any"
    CEIL = "ceil"
    COS = "cos"
    EXP = "exp"
    EXP2 = "exp2"
    FLOOR = "floor"
    FRACT = "fract"
    INV_SQRT = "inverse_sqrt"
    LENGTH = "length"
    LOG = "log"
    LOG2 = "log2"
    NORMALIZE = "normalize"
    PACK4X8SNORM = "pack4x8snorm"
    PACK4X8UNORM = "pack4x8unorm"
    ROUND = "round"
    SATURATE = "saturate"
    SIGN = "sign"
    SIN = "sin"
    SQRT = "sqrt"
    TAN = "tan"
    UNPACK4X8SNORM = "unpack4x8snorm"
    UNPACK4X8UNORM = "unpack4x8unorm"
    W = "w"
    X = "x"
    Y = "y"
    Z = "z"


class BinaryOp(enum.Enum):
    """Binary operators (reference: graph/expr.rs:2079+)."""

    ADD = "add"
    ATAN2 = "atan2"
    CROSS = "cross"
    DISTANCE = "distance"
    DIV = "div"
    DOT = "dot"
    GE = "ge"
    GT = "gt"
    LE = "le"
    LT = "lt"
    MAX = "max"
    MIN = "min"
    MUL = "mul"
    REM = "rem"
    STEP = "step"
    SUB = "sub"
    UNIFORM_RAND = "uniform_rand"
    NORMAL_RAND = "normal_rand"
    VEC2 = "vec2"
    VEC4_XYZ_W = "vec4_xyz_w"


class TernaryOp(enum.Enum):
    """Ternary operators (reference: graph/expr.rs:2305+)."""

    MIX = "mix"
    CLAMP = "clamp"
    SMOOTHSTEP = "smoothstep"
    VEC3 = "vec3"


class BuiltInOp(enum.Enum):
    """Built-in variables (reference: graph/expr.rs:1580-1740)."""

    TIME = "time"
    DELTA_TIME = "delta_time"
    VIRTUAL_TIME = "virtual_time"
    VIRTUAL_DELTA_TIME = "virtual_delta_time"
    REAL_TIME = "real_time"
    REAL_DELTA_TIME = "real_delta_time"
    RAND = "rand"  # carries a ValueType payload on the Expr node
    ALPHA_CUTOFF = "alpha_cutoff"  # render context only
    IS_ALIVE = "is_alive"  # update context only
    PARTICLE_INDEX = "particle_index"  # pool slot index (pseudo-attr `id`)


# Comparison ops that return bool (component-wise on vectors, WGSL-style).
_CMP_OPS = {BinaryOp.GE, BinaryOp.GT, BinaryOp.LE, BinaryOp.LT}
# Binary ops whose result is always a scalar f32.
_SCALARIZING_BINOPS = {BinaryOp.DOT, BinaryOp.DISTANCE}


@dataclass(frozen=True)
class Expr:
    """One node in the expression arena.

    ``kind`` is one of: literal, property, attribute, parent_attribute,
    builtin, unary, binary, ternary, cast, texture_sample.
    """

    kind: str
    # literal
    value: Optional[Value] = None
    # property/attribute
    name: Optional[str] = None
    # builtin
    builtin: Optional[BuiltInOp] = None
    rand_type: Optional[ValueType] = None
    # operators
    op: Optional[Union[UnaryOp, BinaryOp, TernaryOp]] = None
    args: Tuple[ExprHandle, ...] = ()
    # cast
    target_type: Optional[ValueType] = None
    # texture_sample
    texture_slot: Optional[int] = None


class Module:
    """Arena of expressions + property/texture declarations.

    Mirrors the reference ``Module`` (graph/expr.rs:337-780). Serializable to
    JSON so an :class:`~bevy_hanabi_tpu.asset.EffectAsset` round-trips like
    the reference's RON assets.
    """

    def __init__(self) -> None:
        self._exprs: List[Expr] = []
        self._properties: Dict[str, Value] = {}
        self._texture_slots: List[str] = []

    # ---- arena --------------------------------------------------------

    def _push(self, e: Expr) -> ExprHandle:
        self._exprs.append(e)
        return len(self._exprs)  # 1-based

    def get(self, h: ExprHandle) -> Expr:
        if not (1 <= h <= len(self._exprs)):
            raise IndexError(f"invalid ExprHandle {h}")
        return self._exprs[h - 1]

    def __len__(self) -> int:
        return len(self._exprs)

    # ---- constructors (reference: lit/attr/prop/binary/... ) ----------

    def lit(self, v, vt: ValueType = None) -> ExprHandle:
        return self._push(Expr("literal", value=as_value(v, vt)))

    def attr(self, attribute) -> ExprHandle:
        a = attribute if isinstance(attribute, Attribute) else Attribute.from_name(attribute)
        return self._push(Expr("attribute", name=a.name))

    def parent_attr(self, attribute) -> ExprHandle:
        a = attribute if isinstance(attribute, Attribute) else Attribute.from_name(attribute)
        return self._push(Expr("parent_attribute", name=a.name))

    def add_property(self, name: str, default) -> str:
        """Declare a runtime-tunable property; returns its name as handle."""
        self._properties[name] = as_value(default)
        return name

    def properties(self) -> Dict[str, Value]:
        return dict(self._properties)

    def prop(self, name: str) -> ExprHandle:
        if name not in self._properties:
            raise KeyError(
                f"property {name!r} not declared; call add_property() first"
            )
        return self._push(Expr("property", name=name))

    def add_texture_slot(self, name: str) -> int:
        self._texture_slots.append(name)
        return len(self._texture_slots) - 1

    def texture_slots(self) -> List[str]:
        return list(self._texture_slots)

    def get_slot_by_name(self, name: str) -> Optional[int]:
        """Slot index for a named texture slot (TextureLayout, lib.rs:735)."""
        try:
            return self._texture_slots.index(name)
        except ValueError:
            return None

    def builtin(self, op: BuiltInOp, rand_type: ValueType = None) -> ExprHandle:
        if op is BuiltInOp.RAND and rand_type is None:
            raise ValueError("rand builtin requires a value type")
        return self._push(Expr("builtin", builtin=op, rand_type=rand_type))

    def time(self) -> ExprHandle:
        return self.builtin(BuiltInOp.TIME)

    def delta_time(self) -> ExprHandle:
        return self.builtin(BuiltInOp.DELTA_TIME)

    def rand(self, vt: ValueType) -> ExprHandle:
        if not isinstance(vt, (ScalarType, VectorType)):
            raise TypeError("rand() supports scalar and vector types only")
        return self.builtin(BuiltInOp.RAND, rand_type=vt)

    def unary(self, op: UnaryOp, x: ExprHandle) -> ExprHandle:
        return self._push(Expr("unary", op=op, args=(x,)))

    def binary(self, op: BinaryOp, lhs: ExprHandle, rhs: ExprHandle) -> ExprHandle:
        return self._push(Expr("binary", op=op, args=(lhs, rhs)))

    def ternary(self, op: TernaryOp, a: ExprHandle, b: ExprHandle, c: ExprHandle) -> ExprHandle:
        return self._push(Expr("ternary", op=op, args=(a, b, c)))

    def cast(self, x: ExprHandle, target: ValueType) -> ExprHandle:
        return self._push(Expr("cast", args=(x,), target_type=target))

    def texture_sample(self, slot: int, uv: ExprHandle) -> ExprHandle:
        return self._push(Expr("texture_sample", texture_slot=slot, args=(uv,)))

    # Named shorthands mirroring the reference's Module::add/mul/... sugar.
    def add(self, a, b):
        return self.binary(BinaryOp.ADD, a, b)

    def sub(self, a, b):
        return self.binary(BinaryOp.SUB, a, b)

    def mul(self, a, b):
        return self.binary(BinaryOp.MUL, a, b)

    def div(self, a, b):
        return self.binary(BinaryOp.DIV, a, b)

    def uniform(self, a, b):
        return self.binary(BinaryOp.UNIFORM_RAND, a, b)

    def normal(self, mean, std):
        return self.binary(BinaryOp.NORMAL_RAND, mean, std)

    def mix(self, a, b, t):
        return self.ternary(TernaryOp.MIX, a, b, t)

    def clamp(self, x, lo, hi):
        return self.ternary(TernaryOp.CLAMP, x, lo, hi)

    def vec3(self, x, y, z):
        return self.ternary(TernaryOp.VEC3, x, y, z)

    def vec2(self, x, y):
        return self.binary(BinaryOp.VEC2, x, y)

    # ---- analysis ------------------------------------------------------

    def has_side_effect(self, h: ExprHandle) -> bool:
        """True if evaluating ``h`` draws random numbers.

        Mirrors the reference's side-effect tracking (graph/expr.rs:1049-1064).
        Note the evaluation-cache consequence matches the reference too: a
        side-effecting handle is evaluated ONCE per context and its value
        reused (the reference stores it in a local shader var) — reuse does
        NOT re-draw.
        """
        e = self.get(h)
        if e.kind == "builtin":
            return e.builtin is BuiltInOp.RAND
        if e.kind == "binary" and e.op in (BinaryOp.UNIFORM_RAND, BinaryOp.NORMAL_RAND):
            return True
        return any(self.has_side_effect(a) for a in e.args)

    def is_const(self, h: ExprHandle) -> bool:
        """True if ``h`` is a compile-time constant (graph/expr.rs:1024)."""
        e = self.get(h)
        if e.kind == "literal":
            return True
        if e.kind in ("attribute", "parent_attribute", "property", "builtin",
                      "texture_sample"):
            return False
        return all(self.is_const(a) for a in e.args)

    def infer_type(self, h: ExprHandle) -> ValueType:
        """Static result type of an expression (used by layout derivation)."""
        e = self.get(h)
        if e.kind == "literal":
            return e.value.value_type
        if e.kind == "attribute" or e.kind == "parent_attribute":
            return Attribute.from_name(e.name).value_type
        if e.kind == "property":
            return self._properties[e.name].value_type
        if e.kind == "builtin":
            if e.builtin is BuiltInOp.RAND:
                return e.rand_type
            if e.builtin is BuiltInOp.IS_ALIVE:
                return BOOL
            if e.builtin is BuiltInOp.PARTICLE_INDEX:
                return UINT
            return FLOAT
        if e.kind == "cast":
            return e.target_type
        if e.kind == "texture_sample":
            return VectorType(FLOAT, 4)
        if e.kind == "unary":
            return self._infer_unary(e)
        if e.kind == "binary":
            return self._infer_binary(e)
        if e.kind == "ternary":
            return self._infer_ternary(e)
        raise ValueError(f"unknown expr kind {e.kind!r}")

    def _infer_unary(self, e: Expr) -> ValueType:
        t = self.infer_type(e.args[0])
        op = e.op
        if op in (UnaryOp.X, UnaryOp.Y, UnaryOp.Z, UnaryOp.W):
            if isinstance(t, VectorType):
                return t.elem_type
            return t
        if op is UnaryOp.LENGTH:
            return FLOAT
        if op in (UnaryOp.ALL, UnaryOp.ANY):
            return BOOL
        if op in (UnaryOp.PACK4X8SNORM, UnaryOp.PACK4X8UNORM):
            return UINT
        if op in (UnaryOp.UNPACK4X8SNORM, UnaryOp.UNPACK4X8UNORM):
            return VectorType(FLOAT, 4)
        return t

    def _infer_binary(self, e: Expr) -> ValueType:
        lt = self.infer_type(e.args[0])
        rt = self.infer_type(e.args[1])
        op = e.op
        if op in _SCALARIZING_BINOPS:
            return FLOAT
        if op is BinaryOp.CROSS:
            return VectorType(FLOAT, 3)
        if op is BinaryOp.VEC2:
            elem = lt if isinstance(lt, ScalarType) else lt.elem_type
            return VectorType(elem, 2)
        if op is BinaryOp.VEC4_XYZ_W:
            return VectorType(FLOAT, 4)
        if op in _CMP_OPS:
            # scalar-vs-vector comparisons broadcast to vecN<bool>
            if isinstance(lt, VectorType):
                return VectorType(BOOL, lt.count)
            if isinstance(rt, VectorType):
                return VectorType(BOOL, rt.count)
            return BOOL
        # arithmetic / min / max / step / rem / rand: broadcast to vector
        if isinstance(lt, VectorType):
            return lt
        if isinstance(rt, VectorType):
            return rt
        return lt

    def _infer_ternary(self, e: Expr) -> ValueType:
        if e.op is TernaryOp.VEC3:
            t0 = self.infer_type(e.args[0])
            elem = t0 if isinstance(t0, ScalarType) else t0.elem_type
            return VectorType(elem, 3)
        if e.op is TernaryOp.SMOOTHSTEP:
            return self.infer_type(e.args[2])
        return self.infer_type(e.args[0])

    # ---- serde -----------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        def vt_str(vt):
            return value_type_to_str(vt) if vt is not None else None

        def value_json(v: Value):
            from ..values import MatrixValue, ScalarValue, VectorValue

            if isinstance(v, ScalarValue):
                return {"t": vt_str(v.value_type), "v": v.value}
            if isinstance(v, VectorValue):
                return {"t": vt_str(v.value_type), "v": list(v.values)}
            return {"t": vt_str(v.value_type), "v": [list(c) for c in v.columns]}

        exprs = []
        for e in self._exprs:
            exprs.append(
                {
                    "kind": e.kind,
                    "value": value_json(e.value) if e.value is not None else None,
                    "name": e.name,
                    "builtin": e.builtin.value if e.builtin else None,
                    "rand_type": vt_str(e.rand_type),
                    "op": e.op.value if e.op else None,
                    "args": list(e.args),
                    "target_type": vt_str(e.target_type),
                    "texture_slot": e.texture_slot,
                }
            )
        return {
            "exprs": exprs,
            "properties": {k: value_json(v) for k, v in self._properties.items()},
            "texture_slots": list(self._texture_slots),
        }

    @staticmethod
    def from_json(data: Dict[str, Any]) -> "Module":
        from ..values import MatrixValue, ScalarValue, VectorValue

        def value_from(j):
            vt = value_type_from_str(j["t"])
            if isinstance(vt, ScalarType):
                return ScalarValue(vt, j["v"])
            if isinstance(vt, VectorType):
                return VectorValue(vt, tuple(j["v"]))
            return MatrixValue(vt, tuple(tuple(c) for c in j["v"]))

        m = Module()
        for name, vj in data.get("properties", {}).items():
            m._properties[name] = value_from(vj)
        m._texture_slots = list(data.get("texture_slots", []))
        _ops = {
            "unary": UnaryOp,
            "binary": BinaryOp,
            "ternary": TernaryOp,
        }
        for ej in data["exprs"]:
            kind = ej["kind"]
            op = None
            if ej.get("op"):
                op = _ops[kind](ej["op"])
            m._exprs.append(
                Expr(
                    kind=kind,
                    value=value_from(ej["value"]) if ej.get("value") else None,
                    name=ej.get("name"),
                    builtin=BuiltInOp(ej["builtin"]) if ej.get("builtin") else None,
                    rand_type=(
                        value_type_from_str(ej["rand_type"])
                        if ej.get("rand_type")
                        else None
                    ),
                    op=op,
                    args=tuple(ej.get("args", ())),
                    target_type=(
                        value_type_from_str(ej["target_type"])
                        if ej.get("target_type")
                        else None
                    ),
                    texture_slot=ej.get("texture_slot"),
                )
            )
        return m


# ---------------------------------------------------------------------------
# Fluent writer sugar (reference: graph/expr.rs:2399-4400)
# ---------------------------------------------------------------------------


class ExprWriter:
    """Fluent builder over a :class:`Module` (reference ``ExprWriter``)."""

    def __init__(self, module: Module = None) -> None:
        self.module = module if module is not None else Module()

    def finish(self) -> Module:
        return self.module

    def _wrap(self, h: ExprHandle) -> "WriterExpr":
        return WriterExpr(self, h)

    def lit(self, v, vt: ValueType = None) -> "WriterExpr":
        return self._wrap(self.module.lit(v, vt))

    def attr(self, attribute) -> "WriterExpr":
        return self._wrap(self.module.attr(attribute))

    def parent_attr(self, attribute) -> "WriterExpr":
        return self._wrap(self.module.parent_attr(attribute))

    def prop(self, name: str) -> "WriterExpr":
        return self._wrap(self.module.prop(name))

    def add_property(self, name: str, default) -> str:
        return self.module.add_property(name, default)

    def time(self) -> "WriterExpr":
        return self._wrap(self.module.time())

    def delta_time(self) -> "WriterExpr":
        return self._wrap(self.module.delta_time())

    def rand(self, vt: ValueType) -> "WriterExpr":
        return self._wrap(self.module.rand(vt))

    def builtin(self, op: BuiltInOp, rand_type: ValueType = None) -> "WriterExpr":
        return self._wrap(self.module.builtin(op, rand_type))


class WriterExpr:
    """Expression-in-progress with operator overloads (reference ``WriterExpr``)."""

    __slots__ = ("writer", "handle")

    def __init__(self, writer: ExprWriter, handle: ExprHandle) -> None:
        self.writer = writer
        self.handle = handle

    def expr(self) -> ExprHandle:
        return self.handle

    # -- internals ------------------------------------------------------

    def _coerce(self, other) -> "WriterExpr":
        if isinstance(other, WriterExpr):
            return other
        return self.writer.lit(other)

    def _un(self, op: UnaryOp) -> "WriterExpr":
        return WriterExpr(self.writer, self.writer.module.unary(op, self.handle))

    def _bin(self, op: BinaryOp, other, reverse=False) -> "WriterExpr":
        o = self._coerce(other)
        a, b = (o.handle, self.handle) if reverse else (self.handle, o.handle)
        return WriterExpr(self.writer, self.writer.module.binary(op, a, b))

    def _tern(self, op: TernaryOp, b, c) -> "WriterExpr":
        bb, cc = self._coerce(b), self._coerce(c)
        return WriterExpr(
            self.writer, self.writer.module.ternary(op, self.handle, bb.handle, cc.handle)
        )

    # -- python operators -------------------------------------------------

    def __add__(self, o):
        return self._bin(BinaryOp.ADD, o)

    def __radd__(self, o):
        return self._bin(BinaryOp.ADD, o, reverse=True)

    def __sub__(self, o):
        return self._bin(BinaryOp.SUB, o)

    def __rsub__(self, o):
        return self._bin(BinaryOp.SUB, o, reverse=True)

    def __mul__(self, o):
        return self._bin(BinaryOp.MUL, o)

    def __rmul__(self, o):
        return self._bin(BinaryOp.MUL, o, reverse=True)

    def __truediv__(self, o):
        return self._bin(BinaryOp.DIV, o)

    def __rtruediv__(self, o):
        return self._bin(BinaryOp.DIV, o, reverse=True)

    def __mod__(self, o):
        return self._bin(BinaryOp.REM, o)

    def __neg__(self):
        return self.writer.lit(0.0) - self

    def __lt__(self, o):
        return self._bin(BinaryOp.LT, o)

    def __le__(self, o):
        return self._bin(BinaryOp.LE, o)

    def __gt__(self, o):
        return self._bin(BinaryOp.GT, o)

    def __ge__(self, o):
        return self._bin(BinaryOp.GE, o)

    # -- named unary methods ----------------------------------------------

    def abs(self):
        return self._un(UnaryOp.ABS)

    def acos(self):
        return self._un(UnaryOp.ACOS)

    def asin(self):
        return self._un(UnaryOp.ASIN)

    def atan(self):
        return self._un(UnaryOp.ATAN)

    def all(self):
        return self._un(UnaryOp.ALL)

    def any(self):
        return self._un(UnaryOp.ANY)

    def ceil(self):
        return self._un(UnaryOp.CEIL)

    def cos(self):
        return self._un(UnaryOp.COS)

    def exp(self):
        return self._un(UnaryOp.EXP)

    def exp2(self):
        return self._un(UnaryOp.EXP2)

    def floor(self):
        return self._un(UnaryOp.FLOOR)

    def fract(self):
        return self._un(UnaryOp.FRACT)

    def inverse_sqrt(self):
        return self._un(UnaryOp.INV_SQRT)

    def length(self):
        return self._un(UnaryOp.LENGTH)

    def log(self):
        return self._un(UnaryOp.LOG)

    def log2(self):
        return self._un(UnaryOp.LOG2)

    def normalized(self):
        return self._un(UnaryOp.NORMALIZE)

    def pack4x8snorm(self):
        return self._un(UnaryOp.PACK4X8SNORM)

    def pack4x8unorm(self):
        return self._un(UnaryOp.PACK4X8UNORM)

    def round(self):
        return self._un(UnaryOp.ROUND)

    def saturate(self):
        return self._un(UnaryOp.SATURATE)

    def sign(self):
        return self._un(UnaryOp.SIGN)

    def sin(self):
        return self._un(UnaryOp.SIN)

    def sqrt(self):
        return self._un(UnaryOp.SQRT)

    def tan(self):
        return self._un(UnaryOp.TAN)

    def unpack4x8snorm(self):
        return self._un(UnaryOp.UNPACK4X8SNORM)

    def unpack4x8unorm(self):
        return self._un(UnaryOp.UNPACK4X8UNORM)

    def x(self):
        return self._un(UnaryOp.X)

    def y(self):
        return self._un(UnaryOp.Y)

    def z(self):
        return self._un(UnaryOp.Z)

    def w(self):
        return self._un(UnaryOp.W)

    # -- named binary/ternary methods ---------------------------------------

    def atan2(self, x):
        return self._bin(BinaryOp.ATAN2, x)

    def cross(self, o):
        return self._bin(BinaryOp.CROSS, o)

    def distance(self, o):
        return self._bin(BinaryOp.DISTANCE, o)

    def dot(self, o):
        return self._bin(BinaryOp.DOT, o)

    def max(self, o):
        return self._bin(BinaryOp.MAX, o)

    def min(self, o):
        return self._bin(BinaryOp.MIN, o)

    def step(self, o):
        """step(edge=self, x=o): 0 if x < edge else 1."""
        return self._bin(BinaryOp.STEP, o)

    def uniform(self, o):
        """Uniform random in [self, o)."""
        return self._bin(BinaryOp.UNIFORM_RAND, o)

    def normal(self, std_dev):
        """Normal random with mean=self, std_dev."""
        return self._bin(BinaryOp.NORMAL_RAND, std_dev)

    def vec2(self, y):
        return self._bin(BinaryOp.VEC2, y)

    def vec3(self, y, z):
        return self._tern(TernaryOp.VEC3, y, z)

    def vec4_xyz_w(self, w):
        return self._bin(BinaryOp.VEC4_XYZ_W, w)

    def mix(self, o, t):
        return self._tern(TernaryOp.MIX, o, t)

    def clamp(self, lo, hi):
        return self._tern(TernaryOp.CLAMP, lo, hi)

    def smoothstep(self, hi, x):
        """smoothstep(low=self, high=hi, x)."""
        return self._tern(TernaryOp.SMOOTHSTEP, hi, x)

    def cast(self, target: ValueType):
        return WriterExpr(self.writer, self.writer.module.cast(self.handle, target))
