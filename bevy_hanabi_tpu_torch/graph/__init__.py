"""Effect expression graph: Module/Expr arena, the fluent ExprWriter and
the node-graph layer (``node.py``, a copy of the JAX package's)."""

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
from .node import (  # noqa: F401  (graph/mod.rs:62 node re-exports)
    AddNode,
    AttributeNode,
    ClampNode,
    DivNode,
    LiteralNode,
    MixNode,
    MulNode,
    Node,
    NodeGraph,
    NormalizeNode,
    PropertyNode,
    SubNode,
    TimeNode,
)
