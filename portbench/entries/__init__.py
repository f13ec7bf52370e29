"""One module a kind of call, found by the name a workload file gives under
``"entry"``.  Each holds a class ``Entry(cfg, wl, seed, device, spans)``
whose constructor is the cell's set-up (the scene, the program's objects,
the warm-up) and which offers:

- ``reference_s``: the seconds its set-up spent in the benchmark's own
  reference (the targets), which ``setup_s`` leaves out;
- ``step()``: one call, the unit the window times;
- ``state_line()``: a line on the work's size, printed by a traced run;
- ``release()``: drop the program's state but what the check reads;
- ``outputs()`` / ``follow(prec)`` / ``compare(got, want)``: what the
  program produced, what the reference gives at a precision, and the
  numbers compared;
- ``work(facts)``: the renders of one step with what each layer does to
  them, from the reference's counts, for the roofline shares.
"""
from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    """``spans(name)`` is a ``torch.profiler.record_function`` range while
    ``on`` (the traced stretch of a traced run) and does nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


def reference_phase(make, device):
    """(``make()``, its seconds): the benchmark's own inputs made by the
    reference during set-up, timed to the device's end so that ``setup_s``
    can leave them out; the device's memory peak is then reset, so that
    ``memory_peak_bytes`` is the program's."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = make()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return out, time.perf_counter() - t0
