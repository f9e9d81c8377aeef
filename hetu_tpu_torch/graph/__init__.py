"""The dataflow graph: :class:`~.node.Op` and reverse-mode autodiff."""
from .autodiff import find_topo_sort, gradients, sum_node_list
from .node import ExecContext, Op

__all__ = ["Op", "ExecContext", "gradients", "find_topo_sort",
           "sum_node_list"]
