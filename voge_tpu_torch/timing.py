"""Per-call timing (counterpart of ``voge_tpu/timing.py``).

Each call runs on inputs of its own, ``args_fn(i)`` for a rising ``i``, built
before the clock starts.  The device is ``device``, else that of the first
tensor among the first call's arguments, else the card
(``_device.resolve_device``).  On the card each call is bracketed by its own
pair of CUDA events on the current stream and the device is synchronised
once, after the last call; the events read the time the card spent between
the call's first and last launch, including the host's dispatch while the
card waits for it.  On the CPU each call is timed with
``time.perf_counter``.

The result has ``voge_tpu``'s keys in seconds per call: ``median``,
``estimates`` (the timed calls), ``spread`` (max / min - 1) and
``iqr_spread`` (interquartile range over the median).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from voge_tpu_torch._device import resolve_device


def measure_stats(fn: Callable, args_list: Optional[Sequence] = None, n: int = 20,
                  warmup: int = 1, args_fn: Optional[Callable[[int], tuple]] = None,
                  device=None) -> dict:
    """Seconds per call of ``fn(*args)`` over ``n`` timed calls after
    ``warmup`` untimed ones.

    :param args_list: argument tuples, cycled through; prefer ``args_fn``
    :param args_fn: ``i -> args tuple``, called with ``i = 0, 1, 2, ...``
        (the warm-up calls take the first); overrides ``args_list``
    :param device: where ``fn`` runs (None: see the module note)
    :return: dict with ``median``, ``estimates`` (the ``n`` calls'
        seconds), ``spread`` and ``iqr_spread``
    """
    if args_fn is None:
        if not args_list:
            raise ValueError("measure_stats needs args_fn or a non-empty args_list")
        k = len(args_list)
        args_fn = lambda i: args_list[i % k]
    if n < 1:
        raise ValueError(f"n: expected at least one timed call, got {n}")
    argsets = [args_fn(i) for i in range(warmup + n)]
    dev = resolve_device(device, *argsets[0])
    for a in argsets[:warmup]:
        fn(*a)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for a in argsets[warmup:]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*a)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        ests = [s.elapsed_time(e) / 1e3 for s, e in events]
    else:
        ests = []
        for a in argsets[warmup:]:
            t0 = time.perf_counter()
            fn(*a)
            ests.append(time.perf_counter() - t0)
    med = float(np.median(ests))
    spread = float(max(ests) / min(ests) - 1.0) if len(ests) > 1 and min(ests) > 0 else 0.0
    if len(ests) > 2 and med > 0:
        q25, q75 = np.percentile(ests, [25, 75])
        iqr_spread = float((q75 - q25) / med)
    else:
        iqr_spread = spread
    return {"median": med, "estimates": ests, "spread": spread, "iqr_spread": iqr_spread}


def measure(fn: Callable, args_list: Optional[Sequence] = None, n: int = 20,
            warmup: int = 1, args_fn: Optional[Callable[[int], tuple]] = None,
            device=None) -> float:
    """Median seconds per call of ``fn``: see :func:`measure_stats`."""
    return measure_stats(fn, args_list, n=n, warmup=warmup, args_fn=args_fn,
                         device=device)["median"]
