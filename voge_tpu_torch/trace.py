"""The port's own tracing: spans at its layer boundaries and a registry of
counters, both behind one switch that is off by default.

Off, :func:`span` returns one shared no-op context and :func:`count` /
:func:`count_device` return at once: nothing is allocated, recorded or
launched.  On (:func:`enable`, or ``with tracing():``):

- a span is a ``torch.profiler.record_function`` range named ``voge.<layer>``.
  Spans keep no store and no clock of their own: a running profiler holds
  them on the timeline of its CUDA activity, so every kernel and every idle
  gap can be set against the program span open on the host at the time.
  Parentage is the profiler's nesting on each thread; the backward's spans
  run on the autograd engine's thread, under the step that encloses them in
  time.  Without a profiler a span costs a ``record_function`` and records
  nothing.
- counters accumulate in the registry until :func:`reset`.  Host counts are
  Python integers; device counts (:func:`count_device`) are summed into a
  device tensor on the device's stream, or added into it by a kernel
  (:func:`device_counter`), and read once, by :func:`counts`, so tracing
  adds no host read to a render.

Spans, by layer:

- ``voge.render``: :func:`renderer.render_pipeline`; its self time is the
  inputs' preparation and the fragments' assembly.
- ``voge.coarse``: ``ops.fine.compact_candidates``; ``voge.coarse.read``: the
  coarse stage's host reads (``ops.coarse``).
- ``voge.grouping``: ``ops.cuda_attr.slot_runs``, wherever it is called.
- ``voge.select``: the select's forwards (``FineSelect``,
  ``FineSelectGlobal``, ``RayTraceFine``), with ``voge.select.table``
  (``feature_table``) and ``voge.select.cull`` (the global entry's cone
  cull).
- ``voge.fine_bwd``: the select's backward (``FineSelect.backward``,
  ``ops.fine.global_backward``).
- ``voge.attr`` / ``voge.attr_bwd``: the attribute merge
  (``renderer.interpolate_attr``, ``AttrMerge``) and its backward.
- ``voge.sample`` / ``voge.sample_bwd``: the texture sampler
  (``sampler.SampleFeatures``: the scatter of image rows onto the Gaussians,
  its grouping inside as ``voge.grouping``) and its backward.
- ``voge.similarity``: ``models.pose.feature_similarity`` (on the card the
  two forward kernels of ``ops.cuda_similarity``; the gradient's kernel runs
  in the backward, on autograd's thread, outside the span).
- ``voge.refine``: a ``models.pose.refine_pose`` call, with
  ``voge.refine.pose`` (a step's poses to (R, T), ``pose_matrices``) and
  ``voge.refine.adam`` (the optimizer's step).

Counters:

- ``host_reads``: reads of device values on the render path (the coarse
  stage's, and ``GaussianRenderer``'s camera key);
- ``coarse.reemits``: emissions run again with a wider window;
- ``coarse.slots``: candidate slots (supertile rows x row width) the select
  walks; ``coarse.members``: the occupied ones (device);
  ``coarse.overflow``: members dropped (device);
- ``launch.<entry>``: launches of each kernel wrapper of ``ops/cuda_*.py``
  (their CUDA branch; the plain versions count nothing); ``launch.cull_lists``
  counts the two-level cull's level 1, so it shows that the route engaged;
  ``launch.feature_similarity`` the similarity kernel's calls
  (``ops.cuda_similarity``), so it shows that pose scoring took it, and
  ``launch.feature_similarity_grad`` its gradient's, so it shows that pose
  refinement's backward took it (one a step);
- ``select.copy_bytes_avoided``: the bytes a per-slot copy of the candidates'
  feature rows would write, 64 a compacted slot (host), which K2's compacted
  entry spares by staging each row from the feature table by its id;
- ``refine.steps``: ``refine_pose``'s steps run; ``refine.poses``: the
  poses it refines, once a call (both host);
- ``cull.level1_pairs``: (super-tile, Gaussian) pairs level 1 tests (host);
  ``cull.kept_rows``: the Gaussians its masks keep, over every super-tile
  (device): their ratio is the keep rate, and ``kept_rows`` the rows that
  level 2's blocks examine, a super-tile's rows once for each of its blocks.
"""
from __future__ import annotations

import contextlib
import threading

import torch


class _NoSpan:
    """The span while tracing is off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_on = False
_lock = threading.Lock()
_host: dict = {}       # name -> int
_device: dict = {}     # name -> int64 tensor on the device it counts


def enabled() -> bool:
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop every count."""
    with _lock:
        _host.clear()
        _device.clear()


@contextlib.contextmanager
def tracing():
    """Tracing on for the block, the counters reset on entry; the switch is
    restored on exit and the block's counts stay readable until the next
    :func:`reset`."""
    was = _on
    reset()
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def span(name: str):
    """A ``record_function`` range ``name`` while tracing is on; the shared
    no-op context otherwise."""
    if not _on:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1):
    """Add ``n`` to host counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _host[name] = _host.get(name, 0) + int(n)


def count_device(name: str, values: torch.Tensor):
    """Add the sum of ``values`` to counter ``name`` on their device, with
    no host read, while tracing is on."""
    if not _on:
        return
    total = values.sum(dtype=torch.int64)
    with _lock:
        acc = _device.get(name)
        if acc is None:
            _device[name] = total
        else:
            acc.add_(total.to(acc.device))


def device_counter(name: str, device: torch.device):
    """While tracing is on, the int64 accumulator of counter ``name`` on
    ``device`` (made at 0), for a kernel to add into with no launch of its
    own; None while tracing is off."""
    if not _on:
        return None
    with _lock:
        acc = _device.get(name)
        if acc is None:
            acc = _device[name] = torch.zeros((), dtype=torch.int64, device=device)
    return acc


def counts() -> dict:
    """Every counter's value, the device ones read now (one host read each)."""
    with _lock:
        out = dict(_host)
        dev = dict(_device)
    for name, acc in dev.items():
        out[name] = out.get(name, 0) + int(acc)
    return out
