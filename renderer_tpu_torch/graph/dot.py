"""Graphviz dumps of the active frame plan (``renderer_tpu.graph.dot``'s
``plan_to_dot`` and ``dump``). The port's plan is an ordered list of
passes (``passes/pipeline.py``), so the dump shows the passes in order
and, for each resource a pass reads, an edge from the pass that wrote it;
a resource read as the previous frame left it is a dashed edge from its
writer."""

from __future__ import annotations

import os


def plan_to_dot(passes, switches: dict, name: str = "forward") -> str:
    """The plan's passes and their dependencies as a .dot digraph."""
    writer = {}
    for p in passes:
        for w in p.writes:
            writer[w] = p.name
    sw = ",".join(f"{k}={int(v)}" for k, v in sorted(switches.items()))
    lines = [f'digraph "{name}-plan" {{', "  rankdir=LR;", f'  label="switches: {sw}";']
    for i, p in enumerate(passes):
        lines.append(f'  "{p.name}" [label="{i}: {p.name}", shape=ellipse];')
    for p in passes:
        for r in p.reads:
            if writer.get(r) not in (None, p.name):
                lines.append(f'  "{writer[r]}" -> "{p.name}" [label="{r}"];')
        for r in p.reads_prev:
            if r in writer:
                lines.append(f'  "{writer[r]}" -> "{p.name}" [label="{r}", style=dashed];')
    lines.append("}")
    return "\n".join(lines)


def dump(passes, switches: dict, directory: str, name: str = "forward") -> str:
    """Write ``<directory>/<name>-plan.dot``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}-plan.dot")
    with open(path, "w") as f:
        f.write(plan_to_dot(passes, switches, name))
    return path
