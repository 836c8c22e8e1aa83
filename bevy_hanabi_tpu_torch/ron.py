"""RON interop: read/write the reference's canonical ``.effect`` format.

The reference serializes :class:`EffectAsset` to RON (Rusty Object
Notation) through bevy reflection (``EffectAsset::serialize``,
bevy_hanabi/src/asset.rs:674-748; custom visitor :754-1000;
``EffectAssetLoader`` for ``.effect`` files :1072-1130). This module lets
existing bevy_hanabi assets load directly into this framework — and
exports assets back out in the same format — so a reference user can carry
their ``.effect`` files across unchanged.

Two layers:

* a generic RON parser/writer (:func:`parse` / :func:`dumps`) covering the
  subset serde emits: structs ``(field: value)``, tuples ``(a, b)``, unit /
  newtype / struct enum variants (``Blend``, ``Mask("#3")``,
  ``Unary(op: Abs, expr: "#1")``), lists, maps, options, numbers
  (inf/nan included), strings, bools, and comments;
* schema converters (:func:`asset_from_ron` / :func:`asset_to_ron`)
  mapping the reference's serde schema onto this framework's types:

  - ``Module`` ``(expressions: [...], properties: [...], texture_layout:)``
    (graph/expr.rs:336-344) — expressions replay in arena order so
    ``"#N"`` handles land on the same 1-based indices here;
  - ``Expr`` variants (graph/expr.rs:909-995) with ``ExprHandle``
    serialized as ``"#N"`` strings (graph/expr.rs:160-213),
    ``LiteralExpr``/``PropertyExpr`` transparent (:1268-1271, :1399-1404),
    values via the glam-style ``VectorValueEnum`` (graph/mod.rs:1192);
  - the full modifier set via bevy-reflect type-path maps
    ``{"bevy_hanabi::modifier::accel::AccelModifier": (accel: "#3")}``;
  - ``SpawnerSettings``/``CpuValue`` (spawn.rs:217-253, :80-92),
    ``AlphaMode`` incl. ``Mask(handle)`` (asset.rs:117-210), the
    simulation enums, and ``Gradient`` keys (gradient.rs:59-133).

``EffectAsset.mesh`` is a Bevy ``AssetPath`` in the reference (asset.rs:335)
— it names a mesh asset this framework cannot resolve, so the path is
carried OPAQUELY on ``EffectAsset.mesh_asset_path``: a mesh-bearing
reference file round-trips byte-identically (with a warning that the mesh
itself renders as a quad unless a ``ParticleMesh`` is assigned).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Unit",
    "Seq",
    "Rec",
    "parse",
    "dumps",
    "asset_from_ron",
    "asset_to_ron",
    "RonError",
]


class RonError(ValueError):
    """Malformed RON text or a schema mismatch during conversion."""


# ---------------------------------------------------------------------------
# Generic RON value model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Unit:
    """A bare identifier: unit enum variant or unit struct (``Blend``)."""

    name: str


@dataclass(frozen=True)
class Seq:
    """Positional parenthesized value: tuple / tuple-struct / newtype or
    tuple enum variant. ``name`` is None for anonymous tuples ``(a, b)``."""

    name: Optional[str]
    items: Tuple[Any, ...]


@dataclass(frozen=True)
class Rec:
    """Named-field parenthesized value: struct or struct enum variant.
    ``name`` is None for anonymous structs ``(field: value)``."""

    name: Optional[str]
    fields: Tuple[Tuple[str, Any], ...]

    def get(self, key, default=None):
        for k, v in self.fields:
            if k == key:
                return v
        return default

    def __contains__(self, key):
        return any(k == key for k, _ in self.fields)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_PUNCT = set("()[]{},:")


class _Lexer:
    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0
        self.n = len(text)

    def error(self, msg: str) -> RonError:
        line = self.text.count("\n", 0, self.pos) + 1
        col = self.pos - self.text.rfind("\n", 0, self.pos)
        return RonError(f"RON parse error at line {line}, col {col}: {msg}")

    def _skip_ws(self) -> None:
        t, n = self.text, self.n
        while self.pos < n:
            c = t[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "/" and self.pos + 1 < n and t[self.pos + 1] == "/":
                nl = t.find("\n", self.pos)
                self.pos = n if nl < 0 else nl + 1
            elif c == "/" and self.pos + 1 < n and t[self.pos + 1] == "*":
                end = t.find("*/", self.pos + 2)
                if end < 0:
                    raise self.error("unterminated block comment")
                self.pos = end + 2
            else:
                return

    def peek(self) -> Optional[str]:
        self._skip_ws()
        return self.text[self.pos] if self.pos < self.n else None

    def expect(self, ch: str) -> None:
        if self.peek() != ch:
            raise self.error(f"expected {ch!r}")
        self.pos += 1

    def try_consume(self, ch: str) -> bool:
        if self.peek() == ch:
            self.pos += 1
            return True
        return False

    def ident(self) -> str:
        self._skip_ws()
        start = self.pos
        t = self.text
        while self.pos < self.n and (t[self.pos].isalnum() or t[self.pos] == "_"):
            self.pos += 1
        if self.pos == start:
            raise self.error("expected identifier")
        return t[start : self.pos]

    def string(self) -> str:
        self.expect('"')
        out = []
        t = self.text
        while self.pos < self.n:
            c = t[self.pos]
            self.pos += 1
            if c == '"':
                return "".join(out)
            if c == "\\":
                if self.pos >= self.n:
                    break
                e = t[self.pos]
                self.pos += 1
                if e == "n":
                    out.append("\n")
                elif e == "t":
                    out.append("\t")
                elif e == "r":
                    out.append("\r")
                elif e == "0":
                    out.append("\0")
                elif e == "u":
                    if t[self.pos] != "{":
                        raise self.error("expected '{' in \\u escape")
                    end = t.find("}", self.pos)
                    out.append(chr(int(t[self.pos + 1 : end], 16)))
                    self.pos = end + 1
                else:
                    out.append(e)  # \" \\ \' etc.
            else:
                out.append(c)
        raise self.error("unterminated string")

    def number(self):
        self._skip_ws()
        t = self.text
        start = self.pos
        if self.pos < self.n and t[self.pos] in "+-":
            self.pos += 1
        # inf / NaN with sign
        for word, val in (("inf", math.inf), ("NaN", math.nan), ("nan", math.nan)):
            if t.startswith(word, self.pos):
                self.pos += len(word)
                return -val if t[start] == "-" else val
        isfloat = False
        if t.startswith("0x", self.pos) or t.startswith("0b", self.pos):
            base = 16 if t[self.pos + 1] == "x" else 2
            self.pos += 2
            d0 = self.pos
            while self.pos < self.n and (t[self.pos].isalnum() or t[self.pos] == "_"):
                self.pos += 1
            v = int(t[d0 : self.pos].replace("_", ""), base)
            return -v if t[start] == "-" else v
        while self.pos < self.n and (t[self.pos].isdigit() or t[self.pos] == "_"):
            self.pos += 1
        if self.pos < self.n and t[self.pos] == ".":
            isfloat = True
            self.pos += 1
            while self.pos < self.n and t[self.pos].isdigit():
                self.pos += 1
        if self.pos < self.n and t[self.pos] in "eE":
            isfloat = True
            self.pos += 1
            if self.pos < self.n and t[self.pos] in "+-":
                self.pos += 1
            while self.pos < self.n and t[self.pos].isdigit():
                self.pos += 1
        s = t[start : self.pos].replace("_", "")
        if not s or s in "+-":
            raise self.error("expected number")
        return float(s) if isfloat else int(s)


def _parse_value(lx: _Lexer):
    c = lx.peek()
    if c is None:
        raise lx.error("unexpected end of input")
    if c == '"':
        return lx.string()
    if c == "[":
        lx.expect("[")
        items = []
        while lx.peek() != "]":
            items.append(_parse_value(lx))
            if not lx.try_consume(","):
                break
        lx.expect("]")
        return items
    if c == "{":
        lx.expect("{")
        out = {}
        while lx.peek() != "}":
            k = _parse_value(lx)
            lx.expect(":")
            out[k] = _parse_value(lx)
            if not lx.try_consume(","):
                break
        lx.expect("}")
        return out
    if c == "(":
        return _parse_paren(lx, None)
    if c.isdigit() or c in "+-.":
        return lx.number()
    # identifier-led: bool, inf/nan, unit variant, or Name(...)
    name = lx.ident()
    if name == "true":
        return True
    if name == "false":
        return False
    if name in ("inf", "NaN", "nan"):
        return math.inf if name == "inf" else math.nan
    if lx.peek() == "(":
        return _parse_paren(lx, name)
    return Unit(name)


def _parse_paren(lx: _Lexer, name: Optional[str]):
    """Parse ``( ... )`` as a Rec (``ident:`` fields) or Seq (positional)."""
    lx.expect("(")
    if lx.try_consume(")"):
        return Seq(name, ())
    # Lookahead: identifier followed by ':' means named fields.
    save = lx.pos
    is_rec = False
    ch = lx.peek()
    if ch is not None and (ch.isalpha() or ch == "_"):
        try:
            lx.ident()
            is_rec = lx.peek() == ":"
        except RonError:
            pass
        lx.pos = save
    if is_rec:
        fields = []
        while lx.peek() != ")":
            k = lx.ident()
            lx.expect(":")
            fields.append((k, _parse_value(lx)))
            if not lx.try_consume(","):
                break
        lx.expect(")")
        return Rec(name, tuple(fields))
    items = []
    while lx.peek() != ")":
        items.append(_parse_value(lx))
        if not lx.try_consume(","):
            break
    lx.expect(")")
    return Seq(name, tuple(items))


def parse(text: str):
    """Parse RON text into the Unit/Seq/Rec/primitive value model."""
    lx = _Lexer(text)
    v = _parse_value(lx)
    lx._skip_ws()
    if lx.pos != lx.n:
        raise lx.error("trailing content after value")
    return v


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _fmt_float(v: float) -> str:
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if math.isnan(v):
        return "NaN"
    s = repr(float(v))
    if "e" in s or "E" in s or "." in s:
        return s
    return s + ".0"


def _fmt_str(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\t", "\\t").replace("\r", "\\r")
    return f'"{out}"'


def dumps(value, indent: int = 0) -> str:
    """Serialize the value model back to (pretty) RON — 2-space indentation
    matching the reference's PrettyConfig (asset.rs:676-678)."""
    pad = "  " * indent
    pad1 = "  " * (indent + 1)
    if isinstance(value, Unit):
        return value.name
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _fmt_float(value)
    if isinstance(value, str):
        return _fmt_str(value)
    if value is None:
        return "None"
    if isinstance(value, list):
        if not value:
            return "[]"
        inner = ",\n".join(pad1 + dumps(v, indent + 1) for v in value)
        return "[\n" + inner + ",\n" + pad + "]"
    if isinstance(value, dict):
        if not value:
            return "{}"
        inner = ",\n".join(
            pad1 + dumps(k, indent + 1) + ": " + dumps(v, indent + 1)
            for k, v in value.items()
        )
        return "{\n" + inner + ",\n" + pad + "}"
    if isinstance(value, Seq):
        head = value.name or ""
        if not value.items:
            return head + "()"
        flat = all(
            isinstance(v, (bool, int, float, str, Unit)) for v in value.items
        )
        if flat:
            return head + "(" + ", ".join(dumps(v, indent) for v in value.items) + ")"
        inner = ",\n".join(pad1 + dumps(v, indent + 1) for v in value.items)
        return head + "(\n" + inner + ",\n" + pad + ")"
    if isinstance(value, Rec):
        head = value.name or ""
        if not value.fields:
            return head + "()"
        inner = ",\n".join(
            pad1 + k + ": " + dumps(v, indent + 1) for k, v in value.fields
        )
        return head + "(\n" + inner + ",\n" + pad + ")"
    raise TypeError(f"cannot serialize {type(value).__name__} to RON")


# ---------------------------------------------------------------------------
# Schema conversion: reference serde model <-> this framework
# ---------------------------------------------------------------------------

# CamelCase operator variants (graph/expr.rs UnaryOperator:1832,
# BinaryOperator:2079, TernaryOperator:2305) <-> our enum values.
_UNARY = {
    "Abs": "abs", "Acos": "acos", "Asin": "asin", "Atan": "atan",
    "All": "all", "Any": "any", "Ceil": "ceil", "Cos": "cos",
    "Exp": "exp", "Exp2": "exp2", "Floor": "floor", "Fract": "fract",
    "InvSqrt": "inverse_sqrt", "Length": "length", "Log": "log",
    "Log2": "log2", "Normalize": "normalize",
    "Pack4x8snorm": "pack4x8snorm", "Pack4x8unorm": "pack4x8unorm",
    "Round": "round", "Saturate": "saturate", "Sign": "sign", "Sin": "sin",
    "Sqrt": "sqrt", "Tan": "tan", "Unpack4x8snorm": "unpack4x8snorm",
    "Unpack4x8unorm": "unpack4x8unorm", "W": "w", "X": "x", "Y": "y",
    "Z": "z",
}
_BINARY = {
    "Add": "add", "Atan2": "atan2", "Cross": "cross",
    "Distance": "distance", "Div": "div", "Dot": "dot",
    "GreaterThan": "gt", "GreaterThanOrEqual": "ge", "LessThan": "lt",
    "LessThanOrEqual": "le", "Max": "max", "Min": "min", "Mul": "mul",
    "Remainder": "rem", "Step": "step", "Sub": "sub",
    "UniformRand": "uniform_rand", "NormalRand": "normal_rand",
    "Vec2": "vec2", "Vec4XyzW": "vec4_xyz_w",
}
_TERNARY = {
    "Mix": "mix", "Clamp": "clamp", "SmoothStep": "smoothstep",
    "Vec3": "vec3",
}
_BUILTIN = {
    "Time": "time", "DeltaTime": "delta_time", "VirtualTime": "virtual_time",
    "VirtualDeltaTime": "virtual_delta_time", "RealTime": "real_time",
    "RealDeltaTime": "real_delta_time", "AlphaCutoff": "alpha_cutoff",
    "IsAlive": "is_alive",
}
_UNARY_R = {v: k for k, v in _UNARY.items()}
_BINARY_R = {v: k for k, v in _BINARY.items()}
_TERNARY_R = {v: k for k, v in _TERNARY.items()}
_BUILTIN_R = {v: k for k, v in _BUILTIN.items()}

_SCALAR_TYPES = {"Bool": "bool", "Float": "f32", "Int": "i32", "Uint": "u32"}
_SCALAR_TYPES_R = {v: k for k, v in _SCALAR_TYPES.items()}
_VEC_PREFIX = {"B": "bool", "I": "i32", "U": "u32", "": "f32"}


def _handle_from(v) -> int:
    """``"#N"`` -> N (ExprHandle serde, graph/expr.rs:160-166)."""
    if isinstance(v, str) and v.startswith("#"):
        return int(v[1:])
    raise RonError(f"expected ExprHandle string '#N', got {v!r}")


def _handle_to(h: int) -> str:
    return f"#{int(h)}"


def _opt_from(v):
    """``Some(x)`` / ``None`` -> x / None."""
    if isinstance(v, Unit) and v.name == "None":
        return None
    if isinstance(v, Seq) and v.name == "Some" and len(v.items) == 1:
        return v.items[0]
    raise RonError(f"expected Some(..) or None, got {v!r}")


def _opt_to(v) -> Any:
    return Unit("None") if v is None else Seq("Some", (v,))


def _value_type_from(v) -> str:
    """ValueType RON -> our type string ("f32", "vec3<f32>", "mat3x4<f32>")."""
    if isinstance(v, Seq) and v.name == "Scalar":
        return _SCALAR_TYPES[v.items[0].name]
    if isinstance(v, Seq) and v.name == "Vector":
        rec = v.items[0]
        elem = _SCALAR_TYPES[rec.get("elem_type").name]
        return f"vec{rec.get('count')}<{elem}>"
    if isinstance(v, Seq) and v.name == "Matrix":
        rec = v.items[0]
        return f"mat{rec.get('cols')}x{rec.get('rows')}<f32>"
    raise RonError(f"unsupported ValueType {v!r}")


def _value_type_to(ts: str):
    from .values import value_type_from_str, ScalarType, VectorType

    vt = value_type_from_str(ts)
    if isinstance(vt, ScalarType):
        return Seq("Scalar", (Unit(_SCALAR_TYPES_R[vt.value]),))
    if isinstance(vt, VectorType):
        return Seq(
            "Vector",
            (
                Rec(
                    None,
                    (
                        ("elem_type", Unit(_SCALAR_TYPES_R[vt.elem_type.value])),
                        ("count", vt.count),
                    ),
                ),
            ),
        )
    return Seq(
        "Matrix",
        (Rec(None, (("rows", vt.rows), ("cols", vt.cols))),),
    )


def _value_from(v):
    """Reference ``Value`` RON -> our Value (graph/mod.rs:1481; vectors via
    the glam VectorValueEnum, graph/mod.rs:1192)."""
    from .values import (
        MatrixType,
        MatrixValue,
        ScalarType,
        ScalarValue,
        VectorType,
        VectorValue,
        value_type_from_str,
    )

    if isinstance(v, Seq) and v.name == "Scalar":
        sv = v.items[0]
        st = ScalarType(_SCALAR_TYPES[sv.name])
        raw = sv.items[0]
        if st is ScalarType("bool"):
            return ScalarValue(st, bool(raw))
        if st is ScalarType("f32"):
            return ScalarValue(st, float(raw))
        return ScalarValue(st, int(raw))
    if isinstance(v, Seq) and v.name == "Vector":
        gv = v.items[0]  # e.g. Seq("Vec3", ((x, y, z),)) or Seq("Vec3", (x,y,z))
        name = gv.name
        count = int(name[-1])
        elem = _VEC_PREFIX[name[0] if name[0] in "BIU" else ""]
        if isinstance(gv, Rec) or (
            len(gv.items) == 1 and isinstance(gv.items[0], Rec)
        ):
            # defensive: components as named x/y/z/w fields
            rec = gv if isinstance(gv, Rec) else gv.items[0]
            comps = tuple(rec.get(c) for c in "xyzw"[:count])
        else:
            comps = gv.items
            if len(comps) == 1 and isinstance(comps[0], (Seq, list, tuple)):
                comps = (
                    comps[0].items
                    if isinstance(comps[0], Seq)
                    else tuple(comps[0])
                )
        if len(comps) != count:
            raise RonError(f"vector {name} needs {count} components, got {comps!r}")
        st = ScalarType(elem)
        cast = {
            "bool": bool,
            "f32": float,
            "i32": int,
            "u32": int,
        }[elem]
        return VectorValue(VectorType(st, count), tuple(cast(c) for c in comps))
    if isinstance(v, Seq) and v.name == "Matrix":
        rec = v.items[0]
        mt_rec = rec.get("matrix_type")
        rows = int(mt_rec.get("rows"))
        cols = int(mt_rec.get("cols"))
        storage = rec.get("storage")
        storage = storage.items if isinstance(storage, Seq) else tuple(storage)
        # storage is pre-aligned per WGSL rules (graph/mod.rs:1273-1280):
        # column stride 2 for 2-row matrices, else 4
        stride = 2 if rows == 2 else 4
        columns = tuple(
            tuple(float(storage[c * stride + r]) for r in range(rows))
            for c in range(cols)
        )
        return MatrixValue(MatrixType(rows, cols), columns)
    raise RonError(f"unsupported Value {v!r}")


def _value_to(val):
    from .values import MatrixValue, ScalarValue, VectorValue

    if isinstance(val, ScalarValue):
        name = _SCALAR_TYPES_R[val.value_type.value]
        raw = val.value
        if name == "Float":
            raw = float(raw)
        elif name == "Bool":
            raw = bool(raw)
        else:
            raw = int(raw)
        return Seq("Scalar", (Seq(name, (raw,)),))
    if isinstance(val, VectorValue):
        vt = val.value_type
        prefix = {"bool": "B", "i32": "I", "u32": "U", "f32": ""}[vt.elem_type.value]
        name = f"{prefix}Vec{vt.count}"
        cast = bool if prefix == "B" else (float if prefix == "" else int)
        return Seq("Vector", (Seq(name, (Seq(None, tuple(cast(c) for c in val.values)),)),))
    if isinstance(val, MatrixValue):
        rows, cols = val.value_type.rows, val.value_type.cols
        stride = 2 if rows == 2 else 4
        storage = [0.0] * 16
        for c, col in enumerate(val.columns):
            for r, x in enumerate(col):
                storage[c * stride + r] = float(x)
        return Seq(
            "Matrix",
            (
                Rec(
                    None,
                    (
                        (
                            "matrix_type",
                            Rec(None, (("rows", rows), ("cols", cols))),
                        ),
                        ("storage", Seq(None, tuple(storage))),
                    ),
                ),
            ),
        )
    raise RonError(f"cannot serialize value {val!r}")


# ---- Module ---------------------------------------------------------------


def _module_from(v, warn) -> "Any":
    """Reference Module RON -> our Module, preserving 1-based handle order."""
    from .graph.expr import (
        BinaryOp,
        BuiltInOp,
        Expr,
        Module,
        TernaryOp,
        UnaryOp,
    )
    from .values import value_type_from_str

    m = Module()
    prop_names: List[str] = []
    for p in v.get("properties", []) or []:
        name = p.get("name")
        m.add_property(name, _value_from(p.get("default_value")))
        prop_names.append(name)
    tl = v.get("texture_layout")
    if tl is not None:
        for slot in tl.get("layout", []) or []:
            m.add_texture_slot(slot.get("name"))

    def vt(x):
        return value_type_from_str(_value_type_from(x))

    for ev in v.get("expressions", []) or []:
        if isinstance(ev, Seq) and ev.name == "Literal":
            m._exprs.append(Expr("literal", value=_value_from(ev.items[0])))
        elif isinstance(ev, Seq) and ev.name == "BuiltIn":
            op = ev.items[0].get("operator")
            if isinstance(op, Seq) and op.name == "Rand":
                m._exprs.append(
                    Expr(
                        "builtin",
                        builtin=BuiltInOp("rand"),
                        rand_type=vt(op.items[0]),
                    )
                )
            else:
                m._exprs.append(
                    Expr("builtin", builtin=BuiltInOp(_BUILTIN[op.name]))
                )
        elif isinstance(ev, Seq) and ev.name == "Property":
            idx = int(ev.items[0])  # 1-based PropertyHandle
            if not (1 <= idx <= len(prop_names)):
                raise RonError(f"property handle {idx} out of range")
            m._exprs.append(Expr("property", name=prop_names[idx - 1]))
        elif isinstance(ev, Seq) and ev.name in ("Attribute", "ParentAttribute"):
            kind = "attribute" if ev.name == "Attribute" else "parent_attribute"
            m._exprs.append(Expr(kind, name=ev.items[0].get("attr")))
        elif isinstance(ev, Rec) and ev.name == "Unary":
            m._exprs.append(
                Expr(
                    "unary",
                    op=UnaryOp(_UNARY[ev.get("op").name]),
                    args=(_handle_from(ev.get("expr")),),
                )
            )
        elif isinstance(ev, Rec) and ev.name == "Binary":
            m._exprs.append(
                Expr(
                    "binary",
                    op=BinaryOp(_BINARY[ev.get("op").name]),
                    args=(
                        _handle_from(ev.get("left")),
                        _handle_from(ev.get("right")),
                    ),
                )
            )
        elif isinstance(ev, Rec) and ev.name == "Ternary":
            m._exprs.append(
                Expr(
                    "ternary",
                    op=TernaryOp(_TERNARY[ev.get("op").name]),
                    args=(
                        _handle_from(ev.get("first")),
                        _handle_from(ev.get("second")),
                        _handle_from(ev.get("third")),
                    ),
                )
            )
        elif isinstance(ev, Seq) and ev.name == "Cast":
            rec = ev.items[0]
            m._exprs.append(
                Expr(
                    "cast",
                    args=(_handle_from(rec.get("inner")),),
                    target_type=vt(rec.get("target")),
                )
            )
        elif isinstance(ev, Seq) and ev.name == "TextureSample":
            rec = ev.items[0]
            img_h = _handle_from(rec.get("image"))
            slot = _resolve_slot_literal(m, img_h, warn)
            m._exprs.append(
                Expr(
                    "texture_sample",
                    texture_slot=slot,
                    args=(_handle_from(rec.get("coordinates")),),
                )
            )
        else:
            raise RonError(f"unsupported expression {ev!r}")
    return m


def _resolve_slot_literal(m, handle: int, warn) -> int:
    """The reference's texture slots are expressions (usually literal
    indices); ours are static ints — resolve the literal, else slot 0."""
    try:
        e = m.get(handle)
    except IndexError:
        e = None
    if e is not None and e.kind == "literal":
        try:
            return int(e.value.value)
        except (TypeError, ValueError):
            pass
    warn(
        f"texture slot expression #{handle} is not a literal index; "
        "assuming slot 0"
    )
    return 0


def _module_to(m) -> Tuple[Rec, int]:
    exprs: List[Any] = []
    prop_names = list(m.properties().keys())
    slot_lits: Dict[int, int] = {}  # our slot int -> emitted literal handle

    # Pre-scan: every texture_sample needs a literal slot-index expression in
    # the reference encoding. Ours are static ints, so emit one extra
    # Literal(Scalar(Uint(slot))) per distinct slot FIRST and remap every
    # following handle by the offset.
    slots = []
    for e in m._exprs:
        if e.kind == "texture_sample" and e.texture_slot not in slots:
            slots.append(e.texture_slot)
    offset = len(slots)
    for i, s in enumerate(slots):
        slot_lits[s] = i + 1
        exprs.append(Seq("Literal", (Seq("Scalar", (Seq("Uint", (int(s),)),)),)))

    def h(x):
        return _handle_to(int(x) + offset)

    for e in m._exprs:
        if e.kind == "literal":
            exprs.append(Seq("Literal", (_value_to(e.value),)))
        elif e.kind == "builtin":
            if e.builtin.value == "rand":
                from .values import value_type_to_str

                op = Seq("Rand", (_value_type_to(value_type_to_str(e.rand_type)),))
            elif e.builtin.value in _BUILTIN_R:
                op = Unit(_BUILTIN_R[e.builtin.value])
            else:
                raise RonError(
                    f"builtin {e.builtin.value!r} has no reference RON "
                    "counterpart"
                )
            exprs.append(Seq("BuiltIn", (Rec(None, (("operator", op),)),)))
        elif e.kind == "property":
            exprs.append(Seq("Property", (prop_names.index(e.name) + 1,)))
        elif e.kind == "attribute":
            exprs.append(Seq("Attribute", (Rec(None, (("attr", e.name),)),)))
        elif e.kind == "parent_attribute":
            exprs.append(
                Seq("ParentAttribute", (Rec(None, (("attr", e.name),)),))
            )
        elif e.kind == "unary":
            exprs.append(
                Rec(
                    "Unary",
                    (
                        ("op", Unit(_UNARY_R[e.op.value])),
                        ("expr", h(e.args[0])),
                    ),
                )
            )
        elif e.kind == "binary":
            exprs.append(
                Rec(
                    "Binary",
                    (
                        ("op", Unit(_BINARY_R[e.op.value])),
                        ("left", h(e.args[0])),
                        ("right", h(e.args[1])),
                    ),
                )
            )
        elif e.kind == "ternary":
            exprs.append(
                Rec(
                    "Ternary",
                    (
                        ("op", Unit(_TERNARY_R[e.op.value])),
                        ("first", h(e.args[0])),
                        ("second", h(e.args[1])),
                        ("third", h(e.args[2])),
                    ),
                )
            )
        elif e.kind == "cast":
            from .values import value_type_to_str

            exprs.append(
                Seq(
                    "Cast",
                    (
                        Rec(
                            None,
                            (
                                ("inner", h(e.args[0])),
                                (
                                    "target",
                                    _value_type_to(
                                        value_type_to_str(e.target_type)
                                    ),
                                ),
                            ),
                        ),
                    ),
                )
            )
        elif e.kind == "texture_sample":
            exprs.append(
                Seq(
                    "TextureSample",
                    (
                        Rec(
                            None,
                            (
                                (
                                    "image",
                                    _handle_to(slot_lits[e.texture_slot]),
                                ),
                                ("coordinates", h(e.args[0])),
                            ),
                        ),
                    ),
                )
            )
        else:
            raise RonError(f"cannot export expression kind {e.kind!r}")
    props = [
        Rec(None, (("name", n), ("default_value", _value_to(v))))
        for n, v in m.properties().items()
    ]
    layout = [Rec(None, (("name", s),)) for s in m.texture_slots()]
    return Rec(
        None,
        (
            ("expressions", exprs),
            ("properties", props),
            ("texture_layout", Rec(None, (("layout", layout),))),
        ),
    ), offset


# ---- CpuValue / Gradient / enums ------------------------------------------


def _cpu_from(v, lanes: int):
    from .cpu_value import CpuValue

    def comp(x):
        if isinstance(x, Seq):  # glam vec tuple
            return tuple(float(c) for c in x.items)
        return float(x)

    if isinstance(v, Seq) and v.name == "Single":
        return CpuValue.single(comp(v.items[0]))
    if isinstance(v, Seq) and v.name == "Uniform":
        pair = v.items[0]
        lo, hi = pair.items if isinstance(pair, Seq) else pair
        return CpuValue.uniform(comp(lo), comp(hi))
    raise RonError(f"unsupported CpuValue {v!r}")


def _cpu_to(cv) -> Seq:
    def comp(x):
        if isinstance(x, (tuple, list)):
            return Seq(None, tuple(float(c) for c in x))
        return float(x)

    if cv.is_uniform:
        return Seq("Uniform", (Seq(None, (comp(cv.value), comp(cv.upper))),))
    return Seq("Single", (comp(cv.value),))


def _gradient_from(v):
    from .gradient import Gradient

    g = Gradient()
    for key in v.get("keys", []) or []:
        val = key.get("value")
        if isinstance(val, Seq):
            val = tuple(float(c) for c in val.items)
        else:
            val = float(val)
        g.add_key(float(key.get("ratio")), val)
    return g


def _gradient_to(g) -> Rec:
    import numpy as np

    keys = []
    for ratio, value in g.keys():
        arr = np.asarray(value, np.float32)
        if arr.ndim == 0:
            val: Any = float(arr)
        else:
            val = Seq(None, tuple(float(c) for c in arr))
        keys.append(Rec(None, (("ratio", float(ratio)), ("value", val))))
    return Rec(None, (("keys", keys),))


_SHAPE_DIM = {"Surface": "surface", "Volume": "volume"}
_ORIENT = {
    "ParallelCameraDepthPlane": "parallel_camera_depth_plane",
    "FaceCameraPosition": "face_camera_position",
    "AlongVelocity": "along_velocity",
}
_SAMPLE_MAP = {
    "Modulate": "modulate",
    "ModulateRGB": "modulate_rgb",
    "ModulateOpacityFromR": "modulate_opacity_from_r",
}
_BLEND_MODE = {"Overwrite": "overwrite", "Add": "add", "Modulate": "modulate"}
_EVENT_COND = {"Always": "always", "OnDie": "on_die"}
for _d in (_SHAPE_DIM, _ORIENT, _SAMPLE_MAP, _BLEND_MODE, _EVENT_COND):
    _d.update({v: k for k, v in list(_d.items())})


# ---- Modifiers ------------------------------------------------------------

# field kind -> (from_ron, to_ron); "expr" handles remap through the module
# exporter's literal-slot offset.
_MOD_FIELDS: Dict[str, Dict[str, str]] = {
    "AccelModifier": {"accel": "expr"},
    "RadialAccelModifier": {"origin": "expr", "accel": "expr"},
    "TangentAccelModifier": {"origin": "expr", "axis": "expr", "accel": "expr"},
    "SetAttributeModifier": {"attribute": "attr", "value": "expr"},
    "InheritAttributeModifier": {"attribute": "attr"},
    "ConformToSphereModifier": {
        "origin": "expr",
        "radius": "expr",
        "influence_dist": "expr",
        "attraction_accel": "expr",
        "max_attraction_speed": "expr",
        "shell_half_thickness": "opt_expr",
        "sticky_factor": "opt_expr",
    },
    "LinearDragModifier": {"drag": "expr"},
    "KillSphereModifier": {
        "center": "expr",
        "sqr_radius": "expr",
        "kill_inside": "bool",
    },
    "KillAabbModifier": {
        "center": "expr",
        "half_size": "expr",
        "kill_inside": "bool",
    },
    "SetPositionCircleModifier": {
        "center": "expr",
        "axis": "expr",
        "radius": "expr",
        "dimension": "shape",
    },
    "SetPositionSphereModifier": {
        "center": "expr",
        "radius": "expr",
        "dimension": "shape",
    },
    "SetPositionCone3dModifier": {
        "height": "expr",
        "base_radius": "expr",
        "top_radius": "expr",
        "dimension": "shape",
    },
    "SetVelocityCircleModifier": {
        "center": "expr",
        "axis": "expr",
        "speed": "expr",
    },
    "SetVelocitySphereModifier": {"center": "expr", "speed": "expr"},
    "SetVelocityTangentModifier": {
        "origin": "expr",
        "axis": "expr",
        "speed": "expr",
    },
    "ParticleTextureModifier": {
        "texture_slot": "slot_expr",
        "sample_mapping": "sample_map",
    },
    "SetColorModifier": {
        "color": "cpu4",
        "blend": "blend_mode",
        "mask": "blend_mask",
    },
    "ColorOverLifetimeModifier": {
        "gradient": "gradient",
        "blend": "blend_mode",
        "mask": "blend_mask",
    },
    "SetSizeModifier": {"size": "cpu3"},
    "SizeOverLifetimeModifier": {
        "gradient": "gradient",
        "screen_space_size": "bool",
    },
    "OrientModifier": {"mode": "orient", "rotation": "opt_expr"},
    "FlipbookModifier": {"sprite_grid_size": "uvec2"},
    "ScreenSpaceSizeModifier": {},
    "RoundModifier": {"roundness": "expr"},
    "EmitSpawnEventModifier": {
        "condition": "event_cond",
        "count": "expr",
        "child_index": "int",
    },
}

# Canonical reflect type paths (module layout of bevy_hanabi/src/modifier/)
_MOD_PATHS = {
    "AccelModifier": "bevy_hanabi::modifier::accel::AccelModifier",
    "RadialAccelModifier": "bevy_hanabi::modifier::accel::RadialAccelModifier",
    "TangentAccelModifier": "bevy_hanabi::modifier::accel::TangentAccelModifier",
    "SetAttributeModifier": "bevy_hanabi::modifier::attr::SetAttributeModifier",
    "InheritAttributeModifier": "bevy_hanabi::modifier::attr::InheritAttributeModifier",
    "ConformToSphereModifier": "bevy_hanabi::modifier::force::ConformToSphereModifier",
    "LinearDragModifier": "bevy_hanabi::modifier::force::LinearDragModifier",
    "KillSphereModifier": "bevy_hanabi::modifier::kill::KillSphereModifier",
    "KillAabbModifier": "bevy_hanabi::modifier::kill::KillAabbModifier",
    "SetPositionCircleModifier": "bevy_hanabi::modifier::position::SetPositionCircleModifier",
    "SetPositionSphereModifier": "bevy_hanabi::modifier::position::SetPositionSphereModifier",
    "SetPositionCone3dModifier": "bevy_hanabi::modifier::position::SetPositionCone3dModifier",
    "SetVelocityCircleModifier": "bevy_hanabi::modifier::velocity::SetVelocityCircleModifier",
    "SetVelocitySphereModifier": "bevy_hanabi::modifier::velocity::SetVelocitySphereModifier",
    "SetVelocityTangentModifier": "bevy_hanabi::modifier::velocity::SetVelocityTangentModifier",
    "ParticleTextureModifier": "bevy_hanabi::modifier::output::ParticleTextureModifier",
    "SetColorModifier": "bevy_hanabi::modifier::output::SetColorModifier",
    "ColorOverLifetimeModifier": "bevy_hanabi::modifier::output::ColorOverLifetimeModifier",
    "SetSizeModifier": "bevy_hanabi::modifier::output::SetSizeModifier",
    "SizeOverLifetimeModifier": "bevy_hanabi::modifier::output::SizeOverLifetimeModifier",
    "OrientModifier": "bevy_hanabi::modifier::output::OrientModifier",
    "FlipbookModifier": "bevy_hanabi::modifier::output::FlipbookModifier",
    "ScreenSpaceSizeModifier": "bevy_hanabi::modifier::output::ScreenSpaceSizeModifier",
    "RoundModifier": "bevy_hanabi::modifier::output::RoundModifier",
    "EmitSpawnEventModifier": "bevy_hanabi::modifier::EmitSpawnEventModifier",
}


def _modifier_classes():
    from .modifiers import (  # noqa: F401
        AccelModifier,
        ColorOverLifetimeModifier,
        ConformToSphereModifier,
        EmitSpawnEventModifier,
        FlipbookModifier,
        InheritAttributeModifier,
        KillAabbModifier,
        KillSphereModifier,
        LinearDragModifier,
        OrientModifier,
        ParticleTextureModifier,
        RadialAccelModifier,
        RoundModifier,
        ScreenSpaceSizeModifier,
        SetAttributeModifier,
        SetColorModifier,
        SetPositionCircleModifier,
        SetPositionCone3dModifier,
        SetPositionSphereModifier,
        SetSizeModifier,
        SetVelocityCircleModifier,
        SetVelocitySphereModifier,
        SetVelocityTangentModifier,
        SizeOverLifetimeModifier,
        TangentAccelModifier,
    )

    return {name: obj for name, obj in locals().items() if name != "name"}


def _field_from(kind: str, v, module, warn):
    from .modifiers.output import (
        ColorBlendMask,
        ColorBlendMode,
        ImageSampleMapping,
        OrientMode,
    )
    from .modifiers.position import ShapeDimension
    from .modifiers.event import EventEmitCondition

    if kind == "expr":
        return _handle_from(v)
    if kind == "opt_expr":
        inner = _opt_from(v)
        return None if inner is None else _handle_from(inner)
    if kind == "attr":
        return v  # attribute name string
    if kind == "bool":
        return bool(v)
    if kind == "int":
        return int(v)
    if kind == "shape":
        return ShapeDimension(_SHAPE_DIM[v.name])
    if kind == "orient":
        return OrientMode(_ORIENT[v.name])
    if kind == "sample_map":
        return ImageSampleMapping(_SAMPLE_MAP[v.name])
    if kind == "blend_mode":
        return ColorBlendMode(_BLEND_MODE[v.name])
    if kind == "blend_mask":
        # newtype bitflags struct serializes as its inner u8
        raw = v.items[0] if isinstance(v, Seq) else v
        return ColorBlendMask(int(raw))
    if kind == "event_cond":
        return EventEmitCondition(_EVENT_COND[v.name])
    if kind == "cpu4":
        return _cpu_from(v, 4)
    if kind == "cpu3":
        return _cpu_from(v, 3)
    if kind == "gradient":
        return _gradient_from(v)
    if kind == "uvec2":
        items = v.items if isinstance(v, Seq) else tuple(v)
        return (int(items[0]), int(items[1]))
    if kind == "slot_expr":
        return _resolve_slot_literal(module, _handle_from(v), warn)
    raise RonError(f"unknown field kind {kind!r}")


def _field_to(kind: str, v, hmap):
    if kind == "expr":
        return hmap(v)
    if kind == "opt_expr":
        return _opt_to(None if v is None else hmap(v))
    if kind == "attr":
        return getattr(v, "name", v)
    if kind == "bool":
        return bool(v)
    if kind == "int":
        return int(v)
    if kind in ("shape", "orient", "sample_map", "blend_mode", "event_cond"):
        table = {
            "shape": _SHAPE_DIM,
            "orient": _ORIENT,
            "sample_map": _SAMPLE_MAP,
            "blend_mode": _BLEND_MODE,
            "event_cond": _EVENT_COND,
        }[kind]
        return Unit(table[v.value])
    if kind == "blend_mask":
        return Seq(None, (int(v),))
    if kind == "cpu4" or kind == "cpu3":
        return _cpu_to(v)
    if kind == "gradient":
        return _gradient_to(v)
    if kind == "uvec2":
        return Seq(None, (int(v[0]), int(v[1])))
    if kind == "slot_expr":
        return None  # handled by caller (needs the slot literal map)
    raise RonError(f"unknown field kind {kind!r}")


def _modifier_from(entry, module, warn):
    """One reflect-map entry {"type::path": (fields)} -> our modifier."""
    if not isinstance(entry, dict) or len(entry) != 1:
        raise RonError(f"expected a single-entry type-path map, got {entry!r}")
    path, val = next(iter(entry.items()))
    cls_name = path.rsplit("::", 1)[-1]
    classes = _modifier_classes()
    if cls_name not in classes or cls_name not in _MOD_FIELDS:
        raise RonError(f"unknown modifier type {path!r}")
    spec = _MOD_FIELDS[cls_name]
    kwargs = {}
    if isinstance(val, Rec):
        for fname, fval in val.fields:
            if fname not in spec:
                warn(f"{cls_name}: ignoring unknown field {fname!r}")
                continue
            kwargs[fname] = _field_from(spec[fname], fval, module, warn)
    elif isinstance(val, Seq) and not val.items:
        pass  # unit struct, e.g. ScreenSpaceSizeModifier
    elif isinstance(val, Unit):
        pass
    else:
        raise RonError(f"unsupported modifier body {val!r}")
    return classes[cls_name](**kwargs)


def _modifier_to(mod, hmap, slot_lits) -> dict:
    import dataclasses

    cls_name = type(mod).__name__
    if cls_name not in _MOD_FIELDS:
        raise RonError(
            f"{cls_name} has no reference RON counterpart (custom modifiers "
            "only export through the JSON format)"
        )
    spec = _MOD_FIELDS[cls_name]
    fields = []
    for f in dataclasses.fields(mod):
        kind = spec.get(f.name)
        if kind is None:
            continue
        v = getattr(mod, f.name)
        if kind == "slot_expr":
            fields.append((f.name, _handle_to(slot_lits[int(v)])))
        else:
            fields.append((f.name, _field_to(kind, v, hmap)))
    body = Rec(None, tuple(fields)) if fields else Seq(None, ())
    return {_MOD_PATHS[cls_name]: body}


# ---- EffectAsset ----------------------------------------------------------

_SIM_SPACE = {"Global": "global", "Local": "local"}
_SIM_COND = {"WhenVisible": "when_visible", "Always": "always"}
_MOTION = {"None": "none", "PreUpdate": "pre_update", "PostUpdate": "post_update"}
for _d in (_SIM_SPACE, _SIM_COND, _MOTION):
    _d.update({v: k for k, v in list(_d.items())})


def asset_from_ron(text: str):
    """Parse a reference-format ``.effect`` RON string into an EffectAsset.

    Mirrors ``EffectAsset::deserialize`` (asset.rs:710-716) and the
    field-by-field visitor (asset.rs:754-1000)."""
    from .asset import (
        AlphaMode,
        EffectAsset,
        MotionIntegration,
        SimulationCondition,
        SimulationSpace,
    )
    from .spawn import SpawnerSettings
    from .utils.diag import warn_once

    warnings: List[str] = []

    def warn(msg: str) -> None:
        warnings.append(msg)
        warn_once(f"ron:{msg}", f"RON import: {msg}")

    root = parse(text)
    if not isinstance(root, Rec):
        raise RonError("expected a top-level EffectAsset struct")

    module = _module_from(root.get("module"), warn)

    sp = root.get("spawner")
    spawner = SpawnerSettings(
        _cpu_from(sp.get("count"), 1),
        _cpu_from(sp.get("spawn_duration"), 1),
        _cpu_from(sp.get("period"), 1),
        int(sp.get("cycle_count", 0)),
        bool(sp.get("starts_active", True)),
        bool(sp.get("emit_on_start", True)),
    )

    asset = EffectAsset(
        root.get("name", ""),
        int(root.get("capacity")),
        spawner,
        module,
    )
    for entry in root.get("init_modifiers", []) or []:
        asset.init(_modifier_from(entry, module, warn))
    for entry in root.get("update_modifiers", []) or []:
        asset.update(_modifier_from(entry, module, warn))
    for entry in root.get("render_modifiers", []) or []:
        asset.render(_modifier_from(entry, module, warn))

    asset.z_layer_2d = float(root.get("z_layer_2d", 0.0))
    asset.simulation_space = SimulationSpace(
        _SIM_SPACE[root.get("simulation_space", Unit("Global")).name]
    )
    asset.simulation_condition = SimulationCondition(
        _SIM_COND[root.get("simulation_condition", Unit("WhenVisible")).name]
    )
    asset.motion_integration = MotionIntegration(
        _MOTION[root.get("motion_integration", Unit("PostUpdate")).name]
    )
    seed = root.get("prng_seed", 0)
    asset.prng_seed = int(seed) if int(seed) != 0 else None

    am = root.get("alpha_mode", Unit("Blend"))
    if isinstance(am, Unit):
        asset.alpha_mode = {
            "Blend": AlphaMode.BLEND,
            "Premultiply": AlphaMode.PREMULTIPLY,
            "Add": AlphaMode.ADD,
            "Multiply": AlphaMode.MULTIPLY,
            "Opaque": AlphaMode.OPAQUE,
        }[am.name]
    elif isinstance(am, Seq) and am.name == "Mask":
        asset.alpha_mode = AlphaMode.mask(_handle_from(am.items[0]))
    else:
        raise RonError(f"unsupported alpha_mode {am!r}")

    mesh = root.get("mesh")
    if mesh is not None and not (isinstance(mesh, Unit) and mesh.name == "None"):
        # Option<AssetPath> (asset.rs:335): carried opaquely so the file
        # round-trips byte-identically. Bevy meshes cannot be resolved
        # here — pair with asset.with_mesh(ParticleMesh) for geometry.
        path = _opt_from(mesh)
        if not isinstance(path, str):
            raise RonError(f"expected mesh: Some(\"<asset path>\"), got {mesh!r}")
        asset.mesh_asset_path = path
        warn(
            f"EffectAsset.mesh names the Bevy mesh asset {path!r}; the path "
            "is preserved for round-trips but cannot be resolved here — "
            "assign renderable geometry via asset.with_mesh(ParticleMesh)"
        )
    return asset


def asset_to_ron(asset) -> str:
    """Serialize an EffectAsset to the reference's canonical RON format
    (field order follows asset.rs:727-748)."""

    module_rec, offset = _module_to(asset.module)
    slot_lits = {}
    slots = []
    for e in asset.module._exprs:
        if e.kind == "texture_sample" and e.texture_slot not in slots:
            slots.append(e.texture_slot)
    for i, s in enumerate(slots):
        slot_lits[s] = i + 1
    # ParticleTextureModifier.texture_slot also needs a literal handle;
    # reuse the module exporter's emitted literals, then any existing uint
    # literal with the slot's value (keeps export idempotent — a reimported
    # asset carries the literal this exporter appended last time), and only
    # append a new literal as the last resort.
    from .values import ScalarValue

    extra = []
    for m in asset.render_modifiers:
        slot = getattr(m, "texture_slot", None)
        if type(m).__name__ == "ParticleTextureModifier" and slot not in slot_lits:
            for i, e in enumerate(asset.module._exprs):
                if (
                    e.kind == "literal"
                    and isinstance(e.value, ScalarValue)
                    and e.value.value_type.value in ("u32", "i32")
                    and int(e.value.value) == int(slot)
                ):
                    slot_lits[slot] = offset + i + 1
                    break
            else:
                slot_lits[slot] = (
                    offset + len(extra) + len(asset.module._exprs) + 1
                )
                extra.append(
                    Seq(
                        "Literal",
                        (Seq("Scalar", (Seq("Uint", (int(slot),)),)),),
                    )
                )
    if extra:
        fields = dict(module_rec.fields)
        fields["expressions"] = list(fields["expressions"]) + extra
        module_rec = Rec(None, tuple(fields.items()))

    def hmap(h):
        return _handle_to(int(h) + offset)

    def mods(lst):
        return [_modifier_to(m, hmap, slot_lits) for m in lst]

    from .asset import AlphaMode

    am = asset.alpha_mode
    if am.kind == "mask":
        am_v: Any = Seq("Mask", (hmap(am.mask_cutoff),))
    else:
        am_v = Unit(
            {
                "blend": "Blend",
                "premultiply": "Premultiply",
                "add": "Add",
                "multiply": "Multiply",
                "opaque": "Opaque",
            }[am.kind]
        )

    sp = asset.spawner
    spawner = Rec(
        None,
        (
            ("count", _cpu_to(sp.count)),
            ("spawn_duration", _cpu_to(sp.spawn_duration)),
            ("period", _cpu_to(sp.period)),
            ("cycle_count", int(sp.cycle_count)),
            ("starts_active", bool(sp.starts_active)),
            ("emit_on_start", bool(sp.emit_on_start)),
        ),
    )

    if asset.mesh is not None and asset.mesh_asset_path is None:
        from .utils.diag import warn_once

        warn_once(
            "ron-export-mesh",
            "RON export: ParticleMesh does not map to a Bevy mesh asset "
            "path; exporting mesh: None (set asset.mesh_asset_path to "
            "emit a path)",
        )

    root = Rec(
        None,
        (
            ("name", asset.name),
            ("capacity", int(asset.capacity)),
            ("spawner", spawner),
            ("z_layer_2d", float(asset.z_layer_2d)),
            ("simulation_space", Unit(_SIM_SPACE[asset.simulation_space.value])),
            (
                "simulation_condition",
                Unit(_SIM_COND[asset.simulation_condition.value]),
            ),
            ("prng_seed", int(asset.prng_seed or 0)),
            ("init_modifiers", mods(asset.init_modifiers)),
            ("update_modifiers", mods(asset.update_modifiers)),
            ("render_modifiers", mods(asset.render_modifiers)),
            (
                "motion_integration",
                Unit(_MOTION[asset.motion_integration.value]),
            ),
            ("module", module_rec),
            ("alpha_mode", am_v),
            ("mesh", _opt_to(asset.mesh_asset_path)),
        ),
    )
    return dumps(root) + "\n"
