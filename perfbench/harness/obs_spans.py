"""What the training cells' span metrics share: the program's own spans,
read from ``repro_torch.obs.BUFFER`` after the window.

The port records a span while a ``torch.profiler`` session records, so
the traced slice fills the buffer without the training run switching obs on.
Each training step is a ``train.step`` span whose ``args["device_ms"]``
is its device time (a CUDA event pair), with ``train.forward``,
``train.backward``, ``train.clip``, ``train.optimizer`` and the model's
``layer.*``, ``moe.*`` and ``loss.head`` spans below it, linked by
``args["id"]`` and ``args["parent"]``.  Parents do not cross threads: on
CUDA the autograd engine runs the backward, and ``remat``'s recompute
with it, on a thread of its own, where the spans opened have no parent.
Such a parentless span belongs to the ``train.backward`` span of its
process whose host interval holds it (the step's thread waits in
``torch.autograd.grad`` while the engine runs).

Only whole steps count: ``train.step`` spans that carry ``device_ms``
and, in a run with a traced slice, lie between the profiler's start and
its stop (``ctx.switches``, perf_counter µs like the spans).  A reader
returns None where no whole step was recorded, as with a program that
records no such spans.
"""

from __future__ import annotations

from harness import port  # noqa: F401  (puts the port's src/ on the path)


def program_spans() -> list[dict]:
    """The complete events in the program's trace buffer."""
    from repro_torch import obs

    return [e for e in obs.BUFFER.events() if e.get("ph") == "X"]


def whole_steps(ctx, spans: list[dict]) -> list[dict]:
    lo, hi = ((ctx.switches[0][1], ctx.switches[-1][0]) if ctx.switches
              else (float("-inf"), float("inf")))
    return [s for s in spans if s["name"] == "train.step"
            and "device_ms" in s["args"] and "id" in s["args"]
            and lo <= s["ts"] and s["ts"] + s["dur"] <= hi]


def ancestors(span: dict, by_id: dict, backwards: list[dict]) -> list[dict]:
    """The spans above ``span``, innermost first (as far as the buffer
    still holds them); a chain that ends in a parentless span other than
    a step goes on through the ``train.backward`` that holds it in time
    (module docstring)."""
    out = []
    top = span
    p = span["args"].get("parent")
    while p is not None and p in by_id:
        top = by_id[p]
        out.append(top)
        p = top["args"].get("parent")
    if p is None and top["name"] != "train.step":
        host = next((b for b in backwards if b is not top
                     and b.get("pid") == top.get("pid")
                     and b["ts"] <= top["ts"]
                     and top["ts"] + top["dur"] <= b["ts"] + b["dur"]), None)
        if host is not None:
            out += [host] + ancestors(host, by_id, backwards)
    return out


def step_share(ctx, counts) -> float | None:
    """Σ ``device_ms`` of the spans inside whole steps for which
    ``counts(span, ancestors)`` holds, over Σ ``device_ms`` of those
    steps (%)."""
    spans = program_spans()
    steps = whole_steps(ctx, spans)
    total = sum(s["args"]["device_ms"] for s in steps)
    if total <= 0:
        return None
    step_ids = {s["args"]["id"] for s in steps}
    by_id = {s["args"]["id"]: s for s in spans if "id" in s["args"]}
    backwards = [s for s in spans if s["name"] == "train.backward"]
    part = 0.0
    for s in spans:
        if "device_ms" not in s["args"]:
            continue
        up = ancestors(s, by_id, backwards)
        if any(a["args"].get("id") in step_ids for a in up) \
                and counts(s, up):
            part += s["args"]["device_ms"]
    return 100.0 * part / total


def optimizer_share(ctx):
    return step_share(ctx, lambda s, up: s["name"] in ("train.clip",
                                                        "train.optimizer"))


def moe_route_share(ctx):
    return step_share(ctx, lambda s, up: s["name"] == "moe.route")


def recompute_share(ctx):
    """``layer.*`` spans under ``train.backward``: the layers that
    ``remat`` runs again in the backward pass."""
    return step_share(ctx, lambda s, up: s["name"].startswith("layer.")
                      and any(a["name"] == "train.backward" for a in up))


def device_ops_per_step(ctx):
    """Device operations of the traced slice over the whole steps in it
    (the profiler switches between steps, so the slice holds whole
    steps)."""
    if ctx.trace is None:
        return None
    n = len(whole_steps(ctx, program_spans()))
    return len(ctx.trace.ops) / n if n else None
