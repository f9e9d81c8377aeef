"""Reverse-mode autodiff over the op graph.

Counterpart of ``hetu_tpu/graph/autodiff.py`` (reference parity:
python/hetu/gpu_ops/executor.py:1867-2034). Walks the reverse
topological order, sums partial adjoints per node, and asks each op for
the gradient ops of its inputs.
"""
from __future__ import annotations

__all__ = ["gradients", "find_topo_sort", "sum_node_list"]


def find_topo_sort(node_list):
    """Post-order DFS topological sort (reference executor.py:1946),
    with an explicit stack: a deep model's graph outgrows Python's
    recursion limit. The order is the recursive walk's."""
    visited = set()
    topo_order = []
    for root in node_list:
        if id(root) in visited:
            continue
        visited.add(id(root))
        stack = [(root, iter(root.inputs))]
        while stack:
            node, it = stack[-1]
            for child in it:
                if id(child) not in visited:
                    visited.add(id(child))
                    stack.append((child, iter(child.inputs)))
                    break
            else:
                stack.pop()
                topo_order.append(node)
    return topo_order


def sum_node_list(node_list, ctx=None):
    """Sum partial adjoints, creating no redundant add nodes (reference
    executor.py:2026)."""
    from ..ops.basic import add_op
    node_list = [n for n in node_list if n is not None]
    if not node_list:
        return None
    result = node_list[0]
    for node in node_list[1:]:
        result = add_op(result, node, ctx=ctx)
    return result


def gradients(output_node, node_list, insert_grad=None):
    """Gradient ops of ``output_node`` with respect to each node of
    ``node_list`` (reference executor.py:1867-1919). ``insert_grad`` is
    the seed adjoint of ``output_node`` (default: OnesLike)."""
    from ..ops.shape import oneslike_op

    if insert_grad is None:
        insert_grad = oneslike_op(output_node, ctx=output_node.raw_ctx)
    node_to_grads = {output_node: [insert_grad]}
    node_to_grad = {}

    for node in reversed(find_topo_sort([output_node])):
        if node not in node_to_grads:
            continue
        grad = sum_node_list(node_to_grads[node], ctx=node.raw_ctx)
        if grad is None:
            continue
        node_to_grad[node] = grad
        if not node.inputs:
            continue
        input_grads = node.gradient(grad)
        if input_grads is None:
            continue
        for inp, ig in zip(node.inputs, input_grads):
            if ig is not None:
                node_to_grads.setdefault(inp, []).append(ig)

    missing = [n.name for n in node_list if n not in node_to_grad]
    if missing:
        raise ValueError(f"no gradient path from {output_node.name} to "
                         f"{missing}")
    return [node_to_grad[n] for n in node_list]
