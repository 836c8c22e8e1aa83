"""Experimental node/slot graph layered over the expression Module.

Re-design of the reference's secondary node API (graph/node.rs:249 ``Graph``,
:446 ``Node`` trait): nodes with named input/output slots, linked into a DAG,
compiled down to :class:`~bevy_hanabi_tpu.graph.expr.Module` expressions.
Useful as the backing model for visual effect editors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..attributes import Attribute
from ..values import ValueType
from .expr import BinaryOp, ExprHandle, Module, TernaryOp, UnaryOp

__all__ = [
    "Node",
    "NodeGraph",
    "LiteralNode",
    "AttributeNode",
    "PropertyNode",
    "TimeNode",
    "AddNode",
    "SubNode",
    "MulNode",
    "DivNode",
    "DotNode",
    "CrossNode",
    "NormalizeNode",
    "MixNode",
    "ClampNode",
]


class Node:
    """A graph node: named input slots, one output expression."""

    INPUTS: Tuple[str, ...] = ()

    def build(self, module: Module, inputs: Dict[str, ExprHandle]) -> ExprHandle:
        raise NotImplementedError


@dataclass
class LiteralNode(Node):
    value: object
    value_type: Optional[ValueType] = None

    def build(self, module, inputs):
        return module.lit(self.value, self.value_type)


@dataclass
class AttributeNode(Node):
    attribute: str

    def __post_init__(self):
        if isinstance(self.attribute, Attribute):
            self.attribute = self.attribute.name

    def build(self, module, inputs):
        return module.attr(self.attribute)


@dataclass
class PropertyNode(Node):
    name: str

    def build(self, module, inputs):
        return module.prop(self.name)


class TimeNode(Node):
    def build(self, module, inputs):
        return module.time()


def _binary_node(name: str, op: BinaryOp):
    class _N(Node):
        INPUTS = ("lhs", "rhs")

        def build(self, module, inputs):
            return module.binary(op, inputs["lhs"], inputs["rhs"])

    _N.__name__ = name
    return _N


AddNode = _binary_node("AddNode", BinaryOp.ADD)
SubNode = _binary_node("SubNode", BinaryOp.SUB)
MulNode = _binary_node("MulNode", BinaryOp.MUL)
DivNode = _binary_node("DivNode", BinaryOp.DIV)
DotNode = _binary_node("DotNode", BinaryOp.DOT)
CrossNode = _binary_node("CrossNode", BinaryOp.CROSS)


class NormalizeNode(Node):
    INPUTS = ("value",)

    def build(self, module, inputs):
        return module.unary(UnaryOp.NORMALIZE, inputs["value"])


class MixNode(Node):
    INPUTS = ("start", "end", "t")

    def build(self, module, inputs):
        return module.ternary(TernaryOp.MIX, inputs["start"], inputs["end"], inputs["t"])


class ClampNode(Node):
    INPUTS = ("value", "min", "max")

    def build(self, module, inputs):
        return module.ternary(TernaryOp.CLAMP, inputs["value"], inputs["min"], inputs["max"])


class NodeGraph:
    """DAG of nodes compiled to module expressions (reference Graph)."""

    def __init__(self) -> None:
        self._nodes: List[Node] = []
        # (dst_node, dst_slot) -> src_node
        self._links: Dict[Tuple[int, str], int] = {}

    def add(self, node: Node) -> int:
        self._nodes.append(node)
        return len(self._nodes) - 1

    def link(self, src: int, dst: int, dst_slot: str) -> None:
        node = self._nodes[dst]
        if dst_slot not in node.INPUTS:
            raise KeyError(
                f"{type(node).__name__} has no input slot {dst_slot!r}; "
                f"slots: {node.INPUTS}"
            )
        self._links[(dst, dst_slot)] = src

    def compile(self, module: Module, output: int) -> ExprHandle:
        """Topologically evaluate into the module; returns the output expr."""
        memo: Dict[int, ExprHandle] = {}
        visiting: set = set()

        def eval_node(i: int) -> ExprHandle:
            if i in memo:
                return memo[i]
            if i in visiting:
                raise ValueError(f"cycle through node {i}")
            visiting.add(i)
            node = self._nodes[i]
            inputs = {}
            for slot in node.INPUTS:
                if (i, slot) not in self._links:
                    raise ValueError(
                        f"unlinked input {slot!r} of node {i} ({type(node).__name__})"
                    )
                inputs[slot] = eval_node(self._links[(i, slot)])
            visiting.discard(i)
            memo[i] = node.build(module, inputs)
            return memo[i]

        return eval_node(output)
