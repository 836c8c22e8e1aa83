"""Expression-graph → PyTorch evaluator (port of ``bevy_hanabi_tpu/compiler.py``).

The JAX package evaluates the Expr graph to JAX arrays while tracing; here
the same walk runs eagerly on torch tensors, so each expression is one (or
a few) device ops. Handle-level memoization and the rand-draw rules are
unchanged.

Array conventions: per-particle tensors are batched — scalars ``[N]``,
vectors ``[N, k]``. Literals/builtins stay unbatched (``[]`` / ``[k]``) and
broadcast lazily. ``UINT`` values ride int64 tensors holding uint32 bit
patterns (see :mod:`.ops.rng`); arithmetic on them wraps modulo 2^32.

:mod:`.codegen` writes the same walk out as one CUDA kernel, which steps
most effects on the card and has to match this walk bit for bit. A change
here to the rand draws' order, the memo rules or an op's semantics, or to a
modifier's ``apply``, must be mirrored there; ``tests/test_torch_step_codegen.py``
holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from .attributes import Attribute
from .graph.expr import BinaryOp, BuiltInOp, Expr, ExprHandle, Module, TernaryOp, UnaryOp
from .ops import rng
from .values import (
    BOOL,
    FLOAT,
    INT,
    UINT,
    ScalarType,
    ValueType,
    VectorType,
    num_lanes,
)

__all__ = [
    "SimParams",
    "EvalContext",
    "eval_expr",
    "InitContext",
    "UpdateContext",
    "RenderContext",
]


_TORCH_DTYPE = {
    BOOL: torch.bool,
    FLOAT: torch.float32,
    INT: torch.int32,
    UINT: rng.U32,
}

def _torch_dtype(vt: ValueType) -> torch.dtype:
    """Storage dtype of a value type in the port."""
    return _TORCH_DTYPE[vt if isinstance(vt, ScalarType) else vt.elem_type]


def _is_u32(x: torch.Tensor) -> bool:
    return x.dtype == rng.U32


@dataclass
class SimParams:
    """Per-frame simulation uniforms (reference: GpuSimParams render/mod.rs:218).

    Fields are python floats (or numpy scalars); they are read on the host
    each frame, so no device sync is involved.
    """

    time: Any = 0.0
    delta_time: Any = 1.0 / 60.0
    virtual_time: Any = None
    virtual_delta_time: Any = None
    real_time: Any = None
    real_delta_time: Any = None

    def get(self, op: BuiltInOp) -> float:
        """The builtin's value, rounded to f32 (a python float)."""
        if op is BuiltInOp.TIME:
            v = self.time
        elif op is BuiltInOp.DELTA_TIME:
            v = self.delta_time
        elif op is BuiltInOp.VIRTUAL_TIME:
            v = self.virtual_time if self.virtual_time is not None else self.time
        elif op is BuiltInOp.VIRTUAL_DELTA_TIME:
            v = (
                self.virtual_delta_time
                if self.virtual_delta_time is not None
                else self.delta_time
            )
        elif op is BuiltInOp.REAL_TIME:
            v = self.real_time if self.real_time is not None else self.time
        elif op is BuiltInOp.REAL_DELTA_TIME:
            v = (
                self.real_delta_time
                if self.real_delta_time is not None
                else self.delta_time
            )
        else:
            raise KeyError(op)
        return float(np.float32(v))


class EvalContext:
    """Evaluation environment for one pass over one effect's particles.

    ``seed`` is the per-lane PCG state tensor; its device is the device
    every constant of the pass is created on. ``textures`` ([H, W, 4] f32
    tensors, by slot) are what ``texture_sample`` reads. With
    ``lane_properties`` every given property value is per lane (``[N]`` /
    ``[N, k]``): an instanced group's lanes each carry their instance's
    value.
    """

    context_name = "generic"

    def __init__(
        self,
        module: Module,
        particle: Dict[str, torch.Tensor],
        seed: torch.Tensor,
        sim: SimParams = None,
        properties: Optional[Dict[str, Any]] = None,
        parent_particle: Optional[Dict[str, torch.Tensor]] = None,
        particle_index: Optional[torch.Tensor] = None,
        alive: Optional[torch.Tensor] = None,
        alpha_cutoff: Optional[Any] = None,
        textures: Optional[list] = None,
        lane_properties: bool = False,
    ) -> None:
        self.module = module
        self.particle = particle
        self.seed = seed
        self.device = seed.device
        self.sim = sim if sim is not None else SimParams()
        self.properties = properties or {}
        self.parent_particle = parent_particle
        self.particle_index = particle_index
        self.alive = alive
        self.alpha_cutoff = alpha_cutoff
        self.textures = textures or []
        self.lane_properties = lane_properties
        self._memo: Dict[ExprHandle, torch.Tensor] = {}

    def const(self, value, dtype) -> torch.Tensor:
        """A host value as a tensor of ``dtype`` on this pass's device."""
        if dtype == rng.U32:
            return rng.as_u32(np.asarray(value).astype(np.uint32).astype(np.int64), self.device)
        return torch.as_tensor(np.asarray(value), device=self.device).to(dtype)

    # -- attribute store ---------------------------------------------------

    def get_attr(self, name: str) -> torch.Tensor:
        if name == "id":
            if self.particle_index is None:
                raise ValueError("particle_index not available in this context")
            return self.particle_index
        if name not in self.particle:
            raise KeyError(
                f"attribute {name!r} not in particle layout {sorted(self.particle)}"
            )
        return self.particle[name]

    def set_attr(self, name: str, value) -> None:
        """Write an attribute (modifiers use this; invalidates memo of reads)."""
        attr = Attribute.from_name(name)
        dtype = _torch_dtype(attr.value_type)
        if not isinstance(value, torch.Tensor):
            value = self.const(value, dtype)
        elif dtype == rng.U32:
            value = rng.as_u32(value)
        else:
            value = value.to(dtype)
        ref = self.particle[name]
        self.particle[name] = value.expand(ref.shape)
        # Reads of this attribute may be memoized; drop stale entries, and
        # conservatively every non-leaf result (it may depend on it).
        stale = [
            h
            for h in self._memo
            if (self.module.get(h).kind == "attribute" and self.module.get(h).name == name)
            or self.module.get(h).args
        ]
        for h in stale:
            del self._memo[h]

    def get_property(self, name: str) -> torch.Tensor:
        decls = self.module.properties()
        if name not in decls:
            raise KeyError(f"property {name!r} not declared on module")
        default = decls[name]
        raw = self.properties.get(name)
        dtype = _torch_dtype(default.value_type)
        if raw is None:
            return self.const(default.to_numpy(), dtype)
        out = raw.to(self.device, dtype) if isinstance(raw, torch.Tensor) else self.const(raw, dtype)
        expected = default.to_numpy().shape
        if self.lane_properties:
            if out.dim() != len(expected) + 1 or tuple(out.shape[1:]) != expected:
                raise ValueError(
                    f"property {name!r} expects per-lane shape [N]x{expected}, "
                    f"got {tuple(out.shape)}"
                )
        elif tuple(out.shape) != expected and tuple(out.shape[-len(expected) or 99 :]) != expected:
            raise ValueError(
                f"property {name!r} expects shape {expected} "
                f"(or batched ...x{expected}), got {tuple(out.shape)}"
            )
        return out

    # -- rand --------------------------------------------------------------

    def draw(self, vt: ValueType):
        count = num_lanes(vt)
        if isinstance(vt, ScalarType) and vt is not FLOAT:
            # Integer/bool variants (reference names urand/irand/brand).
            self.seed = rng.pcg_hash(self.seed)
            bits = rng.pcg_hash(self.seed)
            if vt is UINT:
                return bits
            if vt is INT:
                return bits.to(torch.int32)
            return rng.to_float01(bits) < 0.5
        if isinstance(vt, VectorType) and vt.elem_type is not FLOAT:
            outs = [self.draw(vt.elem_type) for _ in range(count)]
            return torch.stack(outs, dim=-1)
        self.seed, v = rng.rand_vec(self.seed, count)
        return v

    def eval(self, handle: ExprHandle) -> torch.Tensor:
        return eval_expr(self.module, handle, self)

    def eval_vec3(self, handle: ExprHandle) -> torch.Tensor:
        v = self.eval(handle)
        if tuple(v.shape[-1:]) != (3,):
            raise ValueError(f"expected vec3 result, got shape {tuple(v.shape)}")
        return v


class InitContext(EvalContext):
    """Init-pass evaluation (reference: ShaderWriter in Init context)."""

    context_name = "init"


class UpdateContext(EvalContext):
    """Update-pass evaluation (reference: ShaderWriter in Update context).

    ``alive`` is reassigned by :meth:`kill`; ``was_alive`` is the mask at
    pass start (used by ``EventEmitCondition::OnDie``, reference
    modifier/mod.rs:692). Emitted GPU spawn events accumulate in
    :attr:`events_out` as ``(channel, mask, count)`` tuples consumed by the
    runtime; ``count`` is uint32 in the int64 carrier.
    """

    context_name = "update"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.alive is None:
            raise ValueError("UpdateContext requires an alive mask")
        self.was_alive = self.alive
        self.events_out: list = []

    def kill(self, mask: torch.Tensor) -> None:
        """Kill particles where ``mask`` is True (reference: is_alive=false)."""
        self.alive = self.alive & ~mask
        stale = [
            h
            for h in self._memo
            if (
                self.module.get(h).kind == "builtin"
                and self.module.get(h).builtin is BuiltInOp.IS_ALIVE
            )
            or self.module.get(h).args
        ]
        for h in stale:
            del self._memo[h]

    def emit_events(self, channel: int, count, condition: str) -> None:
        if condition == "always":
            mask = self.alive
        elif condition == "on_die":
            mask = self.was_alive & ~self.alive
        else:
            raise ValueError(f"unknown event emit condition {condition!r}")
        count = rng.as_u32(count).expand(mask.shape)
        self.events_out.append((channel, mask, count))


class RenderContext(EvalContext):
    """Render extraction (reference: RenderContext, modifier/mod.rs:371-556).

    Render modifiers mutate the per-particle render outputs below; the
    rasterizer consumes them.
    """

    context_name = "render"

    def __init__(self, *args, camera=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.camera = camera
        self._n = next(iter(self.particle.values())).shape[0] if self.particle else None
        self.color: Optional[torch.Tensor] = None  # vec4
        self.size: Optional[torch.Tensor] = None  # vec3
        self.axis_x: Optional[torch.Tensor] = None
        self.axis_y: Optional[torch.Tensor] = None
        self.axis_z: Optional[torch.Tensor] = None
        self.sprite_grid_size: Optional[tuple] = None  # (cols, rows)
        self.needs_uv: bool = False
        self.roundness: Optional[torch.Tensor] = None
        self.screen_space_size: bool = False
        self.texture_layers: list = []  # [(slot, ImageSampleMapping)]
        # Mesh-normal lighting handshake: extraction sets mesh_has_normals
        # when the asset's mesh carries per-vertex normals; a lighting
        # render modifier may then defer its shading to the rasterizer by
        # setting mesh_lighting = ((lx, ly, lz), band) instead of multiplying
        # the per-particle color (normals vary per fragment on a mesh).
        self.mesh_has_normals: bool = False
        self.mesh_lighting: Optional[tuple] = None

    @property
    def num_particles(self) -> int:
        return self._n


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


def _is_vec(module: Module, h: ExprHandle) -> bool:
    return isinstance(module.infer_type(h), VectorType)


def _align_scalar_vec(a, a_is_vec: bool, b, b_is_vec: bool):
    """Insert a trailing lane axis on a batched scalar paired with a vector."""
    if a_is_vec and not b_is_vec and b.dim() >= 1:
        b = b[..., None]
    if b_is_vec and not a_is_vec and a.dim() >= 1:
        a = a[..., None]
    return a, b


def _promote(a, b):
    """Gentle numeric promotion (int+float → float32, int/uint → uint)."""
    if a.dtype == torch.bool or b.dtype == torch.bool:
        return a, b
    if a.dtype != b.dtype:
        if a.dtype.is_floating_point or b.dtype.is_floating_point:
            return a.to(torch.float32), b.to(torch.float32)
        if _is_u32(a) or _is_u32(b):
            return rng.as_u32(a), rng.as_u32(b)
        return a.to(torch.int32), b.to(torch.int32)
    return a, b


def _saturating_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 -> i32 or u32 (int64) as XLA's ``convert``: truncated toward
    zero, NaN to 0, out-of-range values to the type's ends. The clamp is in
    float first (both ends exact in f32), so the int64 conversion is always
    in range; the top end, 2^31 or 2^32 in f32, gets its own integer clamp."""
    lo, hi = (0, 2**32) if dtype == rng.U32 else (-(2**31), 2**31)
    y = torch.clamp(x.nan_to_num(0.0), lo, hi).to(torch.int64).clamp(max=hi - 1)
    return y.to(dtype)


def eval_expr(module: Module, handle: ExprHandle, ctx: EvalContext) -> torch.Tensor:
    # Every handle memoizes within one context, INCLUDING side-effecting
    # (rand) exprs, as in the JAX package (modifier/mod.rs:309-313).
    if handle in ctx._memo:
        return ctx._memo[handle]
    out = _eval(module, module.get(handle), ctx)
    ctx._memo[handle] = out
    return out


def _eval(module: Module, e: Expr, ctx: EvalContext) -> torch.Tensor:
    if e.kind == "literal":
        return ctx.const(e.value.to_numpy(), _torch_dtype(e.value.value_type))

    if e.kind == "attribute":
        return ctx.get_attr(e.name)

    if e.kind == "parent_attribute":
        if ctx.parent_particle is None:
            raise ValueError(
                f"parent attribute {e.name!r} used but effect has no parent"
            )
        if e.name not in ctx.parent_particle:
            raise KeyError(f"parent layout lacks attribute {e.name!r}")
        return ctx.parent_particle[e.name]

    if e.kind == "property":
        return ctx.get_property(e.name)

    if e.kind == "builtin":
        op = e.builtin
        if op is BuiltInOp.RAND:
            return ctx.draw(e.rand_type)
        if op is BuiltInOp.ALPHA_CUTOFF:
            if ctx.alpha_cutoff is None:
                raise ValueError("alpha_cutoff only available in render context")
            if isinstance(ctx.alpha_cutoff, torch.Tensor):  # the per-particle mask cutoff
                return ctx.alpha_cutoff
            return ctx.const(ctx.alpha_cutoff, torch.float32)
        if op is BuiltInOp.IS_ALIVE:
            if ctx.alive is None:
                raise ValueError("is_alive only available in update context")
            return ctx.alive
        if op is BuiltInOp.PARTICLE_INDEX:
            if ctx.particle_index is None:
                raise ValueError("particle_index not available in this context")
            return ctx.particle_index
        return ctx.const(ctx.sim.get(op), torch.float32)

    if e.kind == "cast":
        x = eval_expr(module, e.args[0], ctx)
        dtype = _torch_dtype(e.target_type)
        if x.dtype.is_floating_point and dtype in (rng.U32, torch.int32):
            return _saturating_int(x, dtype)
        if dtype == rng.U32:
            return rng.as_u32(x)
        return x.to(dtype)

    if e.kind == "texture_sample":
        uv = eval_expr(module, e.args[0], ctx)
        return _sample_texture(ctx, e.texture_slot, uv)

    if e.kind == "unary":
        return _eval_unary(module, e, ctx)
    if e.kind == "binary":
        return _eval_binary(module, e, ctx)
    if e.kind == "ternary":
        return _eval_ternary(module, e, ctx)
    raise ValueError(f"unknown expr kind {e.kind!r}")


_UNARY_FN = {
    UnaryOp.ABS: torch.abs,
    UnaryOp.ACOS: torch.acos,
    UnaryOp.ASIN: torch.asin,
    UnaryOp.ATAN: torch.atan,
    UnaryOp.CEIL: torch.ceil,
    UnaryOp.COS: torch.cos,
    UnaryOp.EXP: torch.exp,
    UnaryOp.EXP2: torch.exp2,
    UnaryOp.FLOOR: torch.floor,
    UnaryOp.LOG: torch.log,
    UnaryOp.LOG2: torch.log2,
    UnaryOp.SIGN: torch.sign,
    UnaryOp.SIN: torch.sin,
    UnaryOp.SQRT: torch.sqrt,
    UnaryOp.TAN: torch.tan,
}


def _eval_unary(module: Module, e: Expr, ctx: EvalContext) -> torch.Tensor:
    op = e.op
    arg_h = e.args[0]
    x = eval_expr(module, arg_h, ctx)
    is_vec = _is_vec(module, arg_h)

    fn = _UNARY_FN.get(op)
    if fn is not None:
        return fn(x)
    if op is UnaryOp.ALL:
        return torch.all(x, dim=-1) if is_vec else x
    if op is UnaryOp.ANY:
        return torch.any(x, dim=-1) if is_vec else x
    if op is UnaryOp.FRACT:
        return x - torch.floor(x)
    if op is UnaryOp.INV_SQRT:
        return 1.0 / torch.sqrt(x)
    if op is UnaryOp.LENGTH:
        return torch.sqrt(torch.sum(x * x, dim=-1)) if is_vec else torch.abs(x)
    if op is UnaryOp.NORMALIZE:
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    if op in (UnaryOp.PACK4X8SNORM, UnaryOp.PACK4X8UNORM):
        if op is UnaryOp.PACK4X8SNORM:
            q = torch.round(torch.clamp(x, -1.0, 1.0) * 127.0).to(torch.int64) & 0xFF
        else:
            q = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int64)
        return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    if op in (UnaryOp.UNPACK4X8SNORM, UnaryOp.UNPACK4X8UNORM):
        u = rng.as_u32(x)
        comps = [(u >> (8 * i)) & 0xFF for i in range(4)]
        if op is UnaryOp.UNPACK4X8UNORM:
            return torch.stack([c.to(torch.float32) / 255.0 for c in comps], dim=-1)
        comps = [torch.where(c > 127, c - 256, c).to(torch.float32) / 127.0 for c in comps]
        return torch.clamp(torch.stack(comps, dim=-1), -1.0, 1.0)
    if op is UnaryOp.ROUND:
        return torch.round(x)  # half to even, like jnp.round
    if op is UnaryOp.SATURATE:
        return torch.clamp(x, 0.0, 1.0)
    if op in (UnaryOp.X, UnaryOp.Y, UnaryOp.Z, UnaryOp.W):
        idx = {"x": 0, "y": 1, "z": 2, "w": 3}[op.value]
        if not is_vec:
            if idx == 0:
                return x
            raise ValueError(f".{op.value} on scalar expression")
        return x[..., idx]
    raise ValueError(f"unhandled unary op {op}")


def _eval_binary(module: Module, e: Expr, ctx: EvalContext) -> torch.Tensor:
    op = e.op
    lh, rh = e.args
    lvec, rvec = _is_vec(module, lh), _is_vec(module, rh)

    # rand ops need the *types* before evaluation so draws are lane-correct.
    if op in (BinaryOp.UNIFORM_RAND, BinaryOp.NORMAL_RAND):
        a = eval_expr(module, lh, ctx)
        b = eval_expr(module, rh, ctx)
        a, b = _align_scalar_vec(a, lvec, b, rvec)
        vt = module.infer_type(lh if lvec or not rvec else rh)
        count = num_lanes(vt) if not isinstance(vt, ScalarType) else 1
        if op is BinaryOp.UNIFORM_RAND:
            ctx.seed, v = rng.rand_uniform(ctx.seed, a, b, count)
        else:
            ctx.seed, v = rng.rand_normal(ctx.seed, a, b, count)
        return v

    a = eval_expr(module, lh, ctx)
    b = eval_expr(module, rh, ctx)

    if op is BinaryOp.VEC2:
        return torch.stack(torch.broadcast_tensors(a, b), dim=-1)
    if op is BinaryOp.VEC4_XYZ_W:
        if b.dim() < a.dim():
            b = b.expand(a.shape[:-1])
        elif b.dim() == a.dim() and a.dim() >= 1:
            # unbatched vec3 xyz with per-particle scalar w: batch the xyz
            a = a.expand(tuple(b.shape) + tuple(a.shape[-1:]))
        return torch.cat([a, b[..., None]], dim=-1)
    if op is BinaryOp.CROSS:
        a, b = torch.broadcast_tensors(a, b)
        return torch.linalg.cross(a, b, dim=-1)
    if op is BinaryOp.DOT:
        return torch.sum(a * b, dim=-1)
    if op is BinaryOp.DISTANCE:
        d = a - b
        return torch.sqrt(torch.sum(d * d, dim=-1)) if lvec else torch.abs(d)

    a, b = _align_scalar_vec(a, lvec, b, rvec)
    a2, b2 = _promote(a, b)
    wrap = _is_u32(a2)

    if op is BinaryOp.ADD:
        return (a2 + b2) & 0xFFFFFFFF if wrap else a2 + b2
    if op is BinaryOp.SUB:
        return (a2 - b2) & 0xFFFFFFFF if wrap else a2 - b2
    if op is BinaryOp.MUL:
        return (a2 * b2) & 0xFFFFFFFF if wrap else a2 * b2
    if op is BinaryOp.DIV:
        return a2 / b2
    if op is BinaryOp.REM:
        # WGSL %: truncated modulo; an integer by zero is the dividend, as lax.rem
        if a2.dtype.is_floating_point:
            return torch.fmod(a2, b2)
        zero = b2 == 0
        return torch.where(zero, a2, torch.fmod(a2, torch.where(zero, 1, b2)))
    if op is BinaryOp.MIN:
        return torch.minimum(a2, b2)
    if op is BinaryOp.MAX:
        return torch.maximum(a2, b2)
    if op is BinaryOp.LT:
        return a2 < b2
    if op is BinaryOp.LE:
        return a2 <= b2
    if op is BinaryOp.GT:
        return a2 > b2
    if op is BinaryOp.GE:
        return a2 >= b2
    if op is BinaryOp.ATAN2:
        return torch.atan2(a2, b2)
    if op is BinaryOp.STEP:
        # step(edge, x): 0 where x < edge, else 1 (WGSL argument order)
        return torch.where(b2 < a2, 0.0, 1.0).to(torch.float32)
    raise ValueError(f"unhandled binary op {op}")


def _eval_ternary(module: Module, e: Expr, ctx: EvalContext) -> torch.Tensor:
    op = e.op
    ah, bh, ch = e.args
    a = eval_expr(module, ah, ctx)
    b = eval_expr(module, bh, ctx)
    c = eval_expr(module, ch, ctx)
    avec, bvec, cvec = (_is_vec(module, h) for h in e.args)

    if op is TernaryOp.VEC3:
        return torch.stack(torch.broadcast_tensors(a, b, c), dim=-1)

    def lane_align(x, x_is_vec, result_is_vec):
        """Add a trailing lane axis to a batched scalar mixed with vectors."""
        if result_is_vec and not x_is_vec and x.dim() >= 1:
            return x[..., None]
        return x

    if op is TernaryOp.MIX:
        res_vec = avec or bvec
        a, b, c = (lane_align(x, v, res_vec) for x, v in ((a, avec), (b, bvec), (c, cvec)))
        return a + (b - a) * c
    if op is TernaryOp.CLAMP:
        b = lane_align(b, bvec, avec)
        c = lane_align(c, cvec, avec)
        return torch.minimum(torch.maximum(a, b), c)
    if op is TernaryOp.SMOOTHSTEP:
        a = lane_align(a, avec, cvec)
        b = lane_align(b, bvec, cvec)
        t = torch.clamp((c - a) / (b - a), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)
    raise ValueError(f"unhandled ternary op {op}")


def _sample_texture(ctx: EvalContext, slot: int, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture sample, repeat addressing (compiler.py:663-690).

    Textures are ``[H, W, 4]`` f32 tensors in :attr:`EvalContext.textures`.
    Equivalent of WGSL ``textureSampleLevel(t, s, uv, 0)``; the texel
    indices are JAX's: ``floor`` cast to int32 as XLA's ``convert`` does,
    then a floored modulo (``jnp.mod``)."""
    if slot >= len(ctx.textures):
        raise IndexError(f"texture slot {slot} not bound ({len(ctx.textures)} bound)")
    tex = torch.as_tensor(ctx.textures[slot], dtype=torch.float32, device=ctx.device)
    h, w = tex.shape[0], tex.shape[1]
    uv = uv.to(torch.float32)
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.remainder(_saturating_int(u0, torch.int32), w).long()
    v0i = torch.remainder(_saturating_int(v0, torch.int32), h).long()
    u1i = torch.remainder(u0i + 1, w)
    v1i = torch.remainder(v0i + 1, h)
    t00 = tex[v0i, u0i]
    t01 = tex[v0i, u1i]
    t10 = tex[v1i, u0i]
    t11 = tex[v1i, u1i]
    top = t00 + (t01 - t00) * fu
    bot = t10 + (t11 - t10) * fu
    return top + (bot - top) * fv
