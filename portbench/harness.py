"""The harness: finds a cell's files by name, runs its set-up, the measured
window (or its traced stretch) and the check, and assembles the result.

Everything of one configuration, one cell or one per-layer metric is a file
of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``workloads/<cell>.json`` (its entry, traffic
and limits), ``entries/<entry>.py``, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import resource
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import tracing
from portbench.layers import matches
from portbench.entries import Spans
from portbench.reference.render import REF

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "voge_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None):
    """(the cell's entry in BENCHMARK.json, None for a workload file it does
    not list; its workload file; its configuration file)."""
    bench = bench or benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    wl = load_json(HERE / "workloads" / f"{name}.json")
    if entry and (wl["config"] != entry["config"] or wl["traffic"]["name"] != entry["traffic"]):
        raise ValueError(f"{name}: workload file and BENCHMARK.json name different "
                         "configurations or traffic")
    return entry, wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def entry_class(name: str):
    return importlib.import_module(f"portbench.entries.{name}").Entry


def metric_module(name: str):
    """``metrics/<name>.py`` (names hold dots, so loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names() -> list[str]:
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py"))


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def closed_loop(step, seconds: float):
    """Calls of ``step`` one after another until ``seconds`` have passed on
    the host clock, the window ending in a synchronisation: (calls, wall
    seconds, each call's milliseconds from CUDA events recorded between
    calls and read after the window)."""
    events = [torch.cuda.Event(enable_timing=True)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    while time.perf_counter() - t0 < seconds:
        step()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return len(events) - 1, wall, [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def profiled_loop(step, seconds: float, host: bool):
    """The closed loop under ``torch.profiler`` for ``seconds``: (the
    profiler, calls, wall seconds).  ``host`` records the host's ops too
    (CPU and CUDA activity); without it only the device's activity is
    traced, which slows the host least."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            step()
            n += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, n, wall


def host_sample():
    """(the process's CPU seconds, its voluntary and involuntary context
    switches)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nvcsw, ru.ru_nivcsw


def cpu_witness() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed then."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i * i
    return (time.perf_counter() - t0) * 1e3


def host_line(a, b, wall: float, w0: float, w1: float) -> str:
    """What the host did over a window, from two :func:`host_sample`s and
    the witness before and after."""
    return (f"host: witness {w0:.3f} ms before the window, {w1:.3f} after; the process's CPU "
            f"{b[0] - a[0]:.3f} s of {wall:.3f} s; context switches {b[1] - a[1]} voluntary, "
            f"{b[2] - a[2]} involuntary")


class Context:
    """What a per-layer metric reads: the trace, the step's renders with
    their counts (``work``), and every metric's kernel patterns."""

    def __init__(self, trace: tracing.Trace, work: list, patterns: dict, step_times=(),
                 window_ms=None):
        self.trace, self.work, self.patterns = trace, work, patterns
        # each call's ms in the untraced window before the traced stretch,
        # and that window's wall ms a call
        self.step_times = list(step_times)
        self.window_ms = window_ms


def reported(bench: dict, name: str, kind: str = "end_to_end") -> list:
    """The metrics of ``kind`` that cell ``name`` reports: those that list it
    under ``workloads``, or list no cells."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def smi_line(query: str = "name,power.limit") -> str:
    """The card's name and power limit (or other ``--query-gpu`` fields),
    from nvidia-smi."""
    import subprocess

    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def quartile_spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / q[1]


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", log=print, files=None) -> dict:
    """One run of cell ``name``: the result's dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``checks``).  ``t_start`` is the process's start on ``time.time()``'s
    clock; ``log`` takes the lines printed before the result; ``files``
    (the CPU tests' small cells) replaces (BENCHMARK.json, the workload
    file, the configuration file)."""
    if files is None:
        bench = benchmark()
        entry, wl, cfg = cell(name, bench)
    else:
        bench, wl, cfg = files
    # the spans open only in the traced stretch: set-up and the untraced
    # window run alike with --trace 0 and 1
    spans = Spans(False)
    on_card = torch.device(device).type == "cuda"
    t_entry = time.time()
    obj = entry_class(wl["entry"])(cfg, wl, seed, device, spans)
    if on_card:
        torch.cuda.synchronize()
    # the reference's targets are the benchmark's inputs, not the program's set-up
    setup_s = time.time() - t_start - obj.reference_s
    log(f"set-up: {setup_s:.3f} s, of which the cell's own {time.time() - t_entry - obj.reference_s:.3f}"
        f" s (scene, the program's objects, warm-up); the reference's targets {obj.reference_s:.3f}"
        " s more, left out")
    metrics, dev = {}, {}
    if not on_card:             # the CPU tests drive the rest of a run
        for _ in range(max(1, int(seconds))):
            obj.step()
        n = max(1, int(seconds))
    elif not trace:
        w0, h0 = cpu_witness(), host_sample()
        n, wall, times = closed_loop(obj.step, seconds)
        h1 = host_sample()
        log(host_line(h0, h1, wall, w0, cpu_witness()))
        log("card after the window (sm MHz, memory MHz, W, C): "
            + smi_line("clocks.sm,clocks.mem,power.draw,temperature.gpu"))
        taken = {"step_ms": wall * 1e3 / n, "step_p95_ms": float(np.percentile(times, 95)),
                 "setup_s": setup_s}
        metrics = {m["name"]: (taken[m["name"]], m["unit"]) for m in reported(bench, name)}
        half = n // 2
        log(f"window: {n} calls in {wall:.6f} s; per-call event ms median "
            f"{statistics.median(times):.6f}, quartile spread "
            f"{quartile_spread(times) if n >= 4 else float('nan'):.6f}; mean of the first "
            f"half {statistics.fmean(times[:half]) if half else float('nan'):.6f}, of the "
            f"second {statistics.fmean(times[half:]):.6f}")
    else:
        # the untraced window first (the per-layer tail and the idle share
        # read it); then a stretch tracing the device alone, which the
        # metrics read; then one as long with the host's ops and the spans,
        # which labels the idle gaps
        n0, wall0, times = closed_loop(obj.step, seconds)
        traced = min(seconds, wl.get("trace_seconds", seconds))
        tr = tracing.read(*profiled_loop(obj.step, traced, host=False))
        spans.on = True
        tr.gaps = tracing.idle_gaps(profiled_loop(obj.step, traced, host=True)[0],
                                    wl["entry"] + ".")
        n = tr.steps
        log(obj.state_line())
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: modules loaded that the port may not use: {bad}")
    obj.release()
    if on_card:
        torch.cuda.empty_cache()
    # the check: the program's outputs against the reference's
    t0 = time.perf_counter()
    ref = obj.follow(REF)
    numbers = obj.compare(obj.outputs(), ref)
    log(f"check: reference in {time.perf_counter() - t0:.3f} s")
    limits = wl["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits) and set(numbers) == set(limits)
    result = {"correct": bool(correct), "attempted": int(n), "failed": 0}
    breakdown = None
    if trace and on_card:
        mods = {m: metric_module(m) for m in metric_names()}
        ctx = Context(tr, obj.work(ref[-1]),
                      {m: mod.PATTERNS for m, mod in mods.items() if hasattr(mod, "PATTERNS")}, times,
                      wall0 * 1e3 / n0)
        log(f"device: busy {tr.busy_s * 1e3 / tr.steps:.6f} ms a call in the device-only trace, "
            f"{tr.window_s * 1e3 / tr.steps:.6f} ms wall a call there, {wall0 * 1e3 / n0:.6f} in "
            "the untraced window")
        for m in reported(bench, name, "per_layer"):
            value = mods[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {
            "device_ops": [[tracing.short_name(k), v / 1e6]
                           for k, v in top({k: us for k, (us, _) in tr.kernels.items()})],
            "idle_gaps": [[k[:100], v / 1e6] for k, v in top(tr.gaps)]}
        unmatched = sorted({tracing.short_name(k) for k in tr.kernels
                            if not any(matches(k, p) for p in ctx.patterns.values())})
        log(f"kernels no layer pattern matches (torch glue): {unmatched}")
    result["metrics"] = {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()}
    result["device"] = dev
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": float(numbers[k]), "limit": limits[k]} for k in limits}
    return result
