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


def _place_new(place, roots, mark, part):
    """Give ``part`` to every node made since node id ``mark`` that
    ``roots`` reach and that has no place yet."""
    stack = list(roots)
    while stack:
        n = stack.pop()
        if n.id >= mark and n not in place:
            place[n] = part
            stack.extend(n.inputs)


def _presum(parts, part_of_node, place, ctx):
    """Partial adjoints of one node grouped by their place: the partials
    made in one other place are summed there, so one value leaves it."""
    from . import node as _node
    by_part = {}
    for p in parts:
        by_part.setdefault(place[p], []).append(p)
    out = []
    for part, group in by_part.items():
        if part == part_of_node or len(group) == 1:
            out.extend(group)
            continue
        mark = _node.G_NODE_ID
        total = sum_node_list(group, ctx=ctx)
        _place_new(place, [total], mark, part)
        out.append(total)
    return out


def gradients(output_node, node_list, insert_grad=None, place=None):
    """Gradient ops of ``output_node`` with respect to each node of
    ``node_list`` (reference executor.py:1867-1919). ``insert_grad`` is
    the seed adjoint of ``output_node`` (default: OnesLike).

    ``place`` ({node: part}, holding every forward node) places the
    gradient graph on the parts of the forward graph, as a pipeline
    places it on its stages: each gradient op made by a forward node's
    adjoint sum or ``gradient()`` joins that node's part (the seed joins
    ``output_node``'s), and a node's partial adjoints made in one other
    part are summed there first. The dict is filled in."""
    from ..ops.shape import oneslike_op
    from . import node as _node

    if insert_grad is None:
        insert_grad = oneslike_op(output_node, ctx=output_node.raw_ctx)
    if place is not None:
        place.setdefault(insert_grad, place[output_node])
    node_to_grads = {output_node: [insert_grad]}
    node_to_grad = {}

    for node in reversed(find_topo_sort([output_node])):
        if node not in node_to_grads:
            continue
        parts = node_to_grads[node]
        if place is not None:
            parts = _presum(parts, place[node], place, node.raw_ctx)
        mark = _node.G_NODE_ID
        grad = sum_node_list(parts, ctx=node.raw_ctx)
        if grad is None:
            continue
        node_to_grad[node] = grad
        made = [grad]
        input_grads = node.gradient(grad) if node.inputs else None
        for inp, ig in zip(node.inputs, input_grads or ()):
            if ig is not None:
                node_to_grads.setdefault(inp, []).append(ig)
                made.append(ig)
        if place is not None:
            _place_new(place, made, mark, place[node])

    missing = [n.name for n in node_list if n not in node_to_grad]
    if missing:
        raise ValueError(f"no gradient path from {output_node.name} to "
                         f"{missing}")
    return [node_to_grad[n] for n in node_list]
