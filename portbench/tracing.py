"""Reading ``torch.profiler`` traces of the window's traced stretches: from
one that traces the device alone, device time by kernel name (kernels,
memsets and copies; user-annotated ranges left out, since an optimizer's
range on the device timeline spans its kernels and the gaps between them
and would count them twice) and the busy time as the union of those
intervals; from one that also records the host's ops, the idle gaps
labelled by what the host was doing."""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    steps: int
    window_s: float
    # device event name -> (microseconds, count)
    kernels: dict = field(default_factory=dict)
    busy_s: float = 0.0
    # host label -> idle microseconds on the device
    gaps: dict = field(default_factory=dict)


def _is_device(ev) -> bool:
    if ev.device_type != torch.autograd.DeviceType.CUDA:
        return False
    if not hasattr(ev, "is_user_annotation"):
        raise RuntimeError("the profiler's events do not mark user-annotated ranges: "
                           "device totals would count them on top of their kernels")
    return not ev.is_user_annotation


def short_name(name: str, n: int = 100) -> str:
    """A kernel's name without its argument list, at most ``n`` characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:n]


def _device_intervals(events) -> list:
    return sorted(((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in events if _is_device(ev)), key=lambda x: x[0])


def _busy_and_gaps(dev):
    """(microseconds of the union of the device intervals, the gaps
    between them)."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def read(prof, steps: int, window_s: float) -> Trace:
    """The trace of ``steps`` calls over ``window_s`` host seconds."""
    dev = _device_intervals(prof.events())
    if not dev:
        raise RuntimeError("the profiler recorded no activity on the device")
    kernels = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        k = kernels[name]
        k[0] += e - s
        k[1] += 1
    busy, _ = _busy_and_gaps(dev)
    return Trace(steps, window_s, {k: tuple(v) for k, v in kernels.items()}, busy / 1e6)


def idle_gaps(prof, span_prefix: str) -> dict:
    """Idle microseconds on the device by host label, from a trace that
    records the host's ops: ``<span> / <innermost host op>``, the span being
    the benchmark's own ``record_function`` range named ``span_prefix...``."""
    events = list(prof.events())
    _, gaps = _busy_and_gaps(_device_intervals(events))
    return _label_gaps(events, gaps, span_prefix)


def _label_gaps(events, gaps, span_prefix):
    """Idle microseconds by host label: at each gap's midpoint, the
    benchmark span open on the host and the host op that started last among
    those open on any thread (nested ranges form a stack a thread)."""
    host = sorted(((ev.time_range.start, ev.time_range.end, ev.name, ev.thread)
                   for ev in events if ev.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda x: x[0])
    stacks = defaultdict(list)
    out = defaultdict(float)
    j = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            s, e, name, th = host[j]
            st = stacks[th]
            while st and st[-1][1] < s:
                st.pop()
            st.append((s, e, name))
            j += 1
        top, span = None, "outside the spans"
        for st in stacks.values():
            while st and st[-1][1] < mid:
                st.pop()
            open_ = [x for x in st if x[1] >= mid]
            for x in open_:
                if x[2].startswith(span_prefix):
                    span = x[2]
            if open_ and (top is None or open_[-1][0] > top[0]):
                top = open_[-1]
        label = f"{span} / {top[2] if top else 'no host op'}"
        out[label] += g1 - g0
    return dict(out)
