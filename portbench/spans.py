"""The program's own spans and counters in a traced stretch, read per step.

The port traces itself (``voge_tpu_torch.trace``): with its tracing on,
each layer boundary is a ``torch.profiler.record_function`` range named
``voge.<layer>``, and its registry counts host reads, the coarse stage's
slots, members, overflow and re-emissions, and each kernel wrapper's
launches.  :func:`read` takes a profile that records the host's ops and
returns, for each span name, a step's:

- ``calls``;
- ``self_ms``: host time inside the span less the spans nested in it on its
  thread (a span's children are the spans whose nearest enclosing span it
  is);
- ``device_ms`` and ``launches``: the kernels, memsets and copies launched
  inside it, each credited to the innermost span open on the launching
  thread when its runtime call was made.

A span the profile does not hold reads None in :func:`value`, never 0.
Host times come from a stretch that records host ops, which inflates every
op by the profiler's own cost: compare them between two versions, not with
an untraced wall.

Run as a script, it traces one cell on the card and prints the table:

    python3 portbench/spans.py --workload cuboid10k.fit_b8 --seed 7 --seconds 1

after the cell's set-up and a warm-up, one stretch tracing the device alone
(device ms by kernel name, as the benchmark's per-layer metrics read them),
then stretches recording the host's ops with the program's tracing off and
on in turns (off, on, on, off), whose wall a call gives tracing's cost.  The
last line of standard output is one JSON object; ``--out`` also writes it to
a file.
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict

import torch

FIELDS = ("calls", "self_ms", "device_ms", "launches")


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def events(prof, prefixes=("voge.",)):
    """(spans, launches) of a profile: spans ``(name, thread, start_us,
    end_us)`` of the CPU ranges whose names start with one of ``prefixes``;
    launches ``(thread, time_us, device event name, device us)``, each
    kernel, memset and copy at its runtime call (``thread`` None where the
    call is not found).

    Read from the profiler's own events (``kineto_results``).  A device
    event and its runtime call (``cuda...``) share a correlation id.  The
    call carries the operating system's thread id, the spans the profiler's
    own; a call made inside an op (``aten::...``, an autograd node) is linked
    to it, which maps the one id to the other.  A kernel launched by the
    port's own wrappers outside any op is then placed by its call's thread
    and time alone."""
    evs = prof.profiler.kineto_results.events()
    t0 = min((ev.start_ns() for ev in evs), default=0)
    us = lambda ns: (ns - t0) / 1e3        # from the first event: exact in a float
    spans, ops, calls = [], {}, {}
    for ev in evs:
        if ev.device_type() != CPU:
            continue
        if ev.name().startswith("cu"):
            calls[ev.correlation_id()] = ev
            continue
        ops[ev.correlation_id()] = ev
        if ev.name().startswith(tuple(prefixes)):
            spans.append((ev.name(), ev.start_thread_id(), us(ev.start_ns()), us(ev.end_ns())))
    thread_of = {}
    for call in calls.values():
        op = ops.get(call.linked_correlation_id())
        if op is not None:
            thread_of.setdefault(call.start_thread_id(), op.start_thread_id())
    launches = []
    for ev in evs:
        if ev.device_type() != CUDA or ev.is_user_annotation():
            continue
        call = calls.get(ev.correlation_id())
        thread = None if call is None else thread_of.get(call.start_thread_id())
        t = None if thread is None else us(call.start_ns())
        launches.append((thread, t, ev.name(), (ev.end_ns() - ev.start_ns()) / 1e3))
    return spans, launches


def owners(spans, launches) -> list:
    """The innermost span (its name) open on each launch's thread at its
    runtime call, None for a launch no span encloses."""
    by_thread, asks = defaultdict(list), defaultdict(list)
    for sp in spans:
        by_thread[sp[1]].append(sp)
    for i, (thread, t, _, _) in enumerate(launches):
        if thread is not None:
            asks[thread].append((t, i))
    out = [None] * len(launches)
    for thread, ask in asks.items():
        ss = sorted(by_thread.get(thread, []), key=lambda sp: (sp[2], -sp[3]))
        stack, j = [], 0
        for t, i in sorted(ask):
            while j < len(ss) and ss[j][2] <= t:
                while stack and stack[-1][3] < ss[j][2]:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            while stack and stack[-1][3] < t:
                stack.pop()
            out[i] = stack[-1][0] if stack else None
    return out


def table(spans, launches, steps: int):
    """({span name: {field: a step}}, the launches no span encloses as
    (device event name, device us)) from :func:`events`' lists."""
    out = defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))
    by_thread = defaultdict(list)
    for sp in spans:
        by_thread[sp[1]].append(sp)
    for ss in by_thread.values():
        stack = []
        for name, _, start, end in sorted(ss, key=lambda sp: (sp[2], -sp[3])):
            while stack and stack[-1][1] < start:
                stack.pop()
            row = out[name]
            row["calls"] += 1
            row["self_ms"] += (end - start) / 1e3
            if stack:
                out[stack[-1][0]]["self_ms"] -= (end - start) / 1e3
            stack.append((name, end))
    outside = []
    for (_, _, name, us), span in zip(launches, owners(spans, launches)):
        if span is None:
            outside.append((name, us))
        else:
            out[span]["device_ms"] += us / 1e3
            out[span]["launches"] += 1
    return {k: {f: v / steps for f, v in row.items()} for k, row in out.items()}, outside


def covered(spans, steps: int) -> dict:
    """{thread: ms a step inside its outermost spans}: what the spans of a
    thread account for of the wall."""
    by_thread = defaultdict(list)
    for _, thread, start, end in spans:
        by_thread[thread].append((start, end))
    out = {}
    for thread, ss in by_thread.items():
        total, reach = 0.0, float("-inf")
        for start, end in sorted(ss):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        out[thread] = total / 1e3 / steps
    return out


def read(prof, steps: int, prefixes=("voge.",)):
    """:func:`table` of a profile over ``steps`` calls."""
    return table(*events(prof, prefixes), steps)


def value(rows: dict, names, field: str):
    """The sum of ``field`` over the spans ``names`` that the table holds;
    None where it holds none of them, and for ``device_ms`` where they
    launched nothing."""
    got = [rows[n] for n in names if n in rows]
    if field == "device_ms" and not any(r["launches"] for r in got):
        return None
    return sum(r[field] for r in got) if got else None


def layers(rows: dict, counts: dict, steps: int) -> dict:
    """The per-step figures of the layers, from a table and the registry's
    counts over the same stretch: None where the stretch holds nothing."""
    per = lambda k: counts[k] / steps if k in counts else None
    slots, members = counts.get("coarse.slots"), counts.get("coarse.members")
    return {
        "coarse.read_wait_ms": value(rows, ["voge.coarse.read"], "self_ms"),
        "host_reads_per_step": per("host_reads") if "voge.coarse" in rows else None,
        "coarse.row_fill_pct": 100.0 * members / slots if slots else None,
        "glue.host_ms": value(rows, ["voge.render"], "self_ms"),
        "coarse.host_ms": value(rows, ["voge.coarse"], "self_ms"),
        "select.host_ms": value(rows, ["voge.select", "voge.select.table", "voge.select.gather",
                                       "voge.select.cull"], "self_ms"),
        "fine_bwd.host_ms": value(rows, ["voge.fine_bwd"], "self_ms"),
        "attr.host_ms": value(rows, ["voge.attr", "voge.attr_bwd"], "self_ms"),
        "gather.device_ms": value(rows, ["voge.select.gather"], "device_ms"),
        "similarity.device_ms": value(rows, ["voge.similarity"], "device_ms"),
    }


def main(argv=None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--warmup", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench/spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from voge_tpu_torch import trace

    from portbench import harness, tracing
    from portbench.entries import Spans
    from portbench.layers import device_ms, matches

    _, wl, cfg = harness.cell(a.workload)
    bench_spans = Spans(False)
    obj = harness.entry_class(wl["entry"])(cfg, wl, a.seed, "cuda", bench_spans)
    harness.closed_loop(obj.step, a.warmup)
    mods = {m: harness.metric_module(m) for m in harness.metric_names()}
    patterns = {m: mod.PATTERNS for m, mod in mods.items() if hasattr(mod, "PATTERNS")}
    dev = tracing.read(*harness.profiled_loop(obj.step, a.seconds, host=False))
    ctx = harness.Context(dev, [], patterns)
    by_pattern = {m: device_ms(ctx, p) for m, p in patterns.items()}
    bench_spans.on = True
    walls, prof_on, n_on, counts = {"off": [], "on": []}, None, 0, {}
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            with trace.tracing():
                prof, n, wall = harness.profiled_loop(obj.step, a.seconds, host=True)
            counts, prof_on, n_on = trace.counts(), prof, n
        else:
            prof, n, wall = harness.profiled_loop(obj.step, a.seconds, host=True)
        walls[mode].append(wall * 1e3 / n)
    t0 = time.perf_counter()
    spans, launches = events(prof_on, ("voge.", wl["entry"] + "."))
    rows, _ = table(spans, launches, n_on)
    own = owners(spans, launches)
    # the program's own kernels (those a layer's patterns match) launched
    # outside every program span
    program = sorted({tracing.short_name(k) for (_, _, k, _), o in zip(launches, own)
                      if not (o or "").startswith("voge.")
                      and any(matches(k, p) for p in patterns.values())})
    # the select layer's kernels credited to its spans, against the same
    # kernels found by name in the same stretch
    sel = patterns["select.device_ms"]
    ms = lambda keep: sum(us for (_, _, k, us), o in zip(launches, own)
                          if keep(o) and matches(k, sel)) / 1e3 / n_on
    spans_sel = ms(lambda o: o in ("voge.select", "voge.select.cull"))
    named_sel = ms(lambda o: True)
    res = {
        "workload": a.workload, "seed": a.seed, "card": harness.smi_line(),
        "steps_traced": n_on, "wall_ms_a_call_host_stretch": walls,
        "spans": {k: rows[k] for k in sorted(rows)},
        "counts_per_step": {k: v / n_on for k, v in sorted(counts.items())},
        "layers": layers(rows, counts, n_on),
        "program_kernels_outside_spans": program,
        "launches_not_placed_per_step": sum(t is None for t, _, _, _ in launches) / n_on,
        "ms_a_step_in_spans_by_thread": covered(spans, n_on),
        "select_kernels_ms": {"credited_to_select_spans": spans_sel,
                              "by_name_same_stretch": named_sel,
                              "by_name_device_only_stretch": by_pattern["select.device_ms"]},
        "device_ms_by_pattern": by_pattern,
        "read_s": time.perf_counter() - t0,
    }
    for k in sorted(rows):
        r = rows[k]
        print(f"span {k:<22} calls {r['calls']:8.3f}  host self ms {r['self_ms']:9.4f}  device ms "
              f"{r['device_ms']:9.4f}  launches {r['launches']:8.3f}  (a step)")
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["OMP_NUM_THREADS"] = "1"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    sys.path.insert(0, ROOT)
    sys.exit(main())
