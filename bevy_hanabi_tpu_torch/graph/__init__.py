"""Effect expression graph: Module/Expr arena and the fluent ExprWriter.

The node-graph layer (``bevy_hanabi_tpu/graph/node.py``) is not part of the
port yet."""

from .expr import (  # noqa: F401
    BinaryOp,
    BuiltInOp,
    Expr,
    ExprHandle,
    ExprWriter,
    Module,
    TernaryOp,
    UnaryOp,
    WriterExpr,
)
