"""The reader of the program's spans (``portbench/spans.py``): self time and
nesting from a CPU profile of nested ``record_function`` ranges and CPU ops,
the division by steps, launches credited to the innermost span open on their
thread, and None, never 0, for a span the stretch does not hold."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import spans

STEPS = 3


@pytest.fixture(scope="module")
def cpu_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(STEPS):
            with record_function("fit.render"):
                with record_function("voge.render"):
                    torch.ones(64).sum()
                    with record_function("voge.coarse"):
                        torch.arange(64).cumsum(0)
                        with record_function("voge.coarse.read"):
                            time.sleep(0.002)
                    with record_function("voge.select"):
                        torch.ones(8, 8) @ torch.ones(8, 8)
            with record_function("not.a.span"):
                torch.zeros(4).add_(1)
    return prof


def _durations(prof, name):
    return [(ev.time_range.end - ev.time_range.start) / 1e3 for ev in prof.events()
            if ev.name == name]


def test_spans_of_a_cpu_profile_by_prefix(cpu_profile):
    got, launches = spans.events(cpu_profile, ("voge.",))
    assert launches == []
    assert sorted({s[0] for s in got}) == ["voge.coarse", "voge.coarse.read", "voge.render",
                                           "voge.select"]
    both, _ = spans.events(cpu_profile, ("voge.", "fit."))
    assert {s[0] for s in both} - {s[0] for s in got} == {"fit.render"}


def test_self_time_nesting_and_steps(cpu_profile):
    rows, outside = spans.read(cpu_profile, STEPS, ("voge.", "fit."))
    assert outside == []
    assert set(rows) == {"fit.render", "voge.render", "voge.coarse", "voge.coarse.read",
                         "voge.select"}
    for name in rows:
        assert rows[name]["calls"] == 1.0 and rows[name]["device_ms"] == 0.0
    dur = {n: sum(_durations(cpu_profile, n)) / STEPS for n in rows}
    want = {
        "fit.render": dur["fit.render"] - dur["voge.render"],
        "voge.render": dur["voge.render"] - dur["voge.coarse"] - dur["voge.select"],
        "voge.coarse": dur["voge.coarse"] - dur["voge.coarse.read"],
        "voge.coarse.read": dur["voge.coarse.read"],
        "voge.select": dur["voge.select"],
    }
    for name, ms in want.items():
        assert rows[name]["self_ms"] == pytest.approx(ms, rel=1e-9, abs=1e-9), name
        assert rows[name]["self_ms"] >= 0
    assert rows["voge.coarse.read"]["self_ms"] >= 2.0
    # the spans tile the outermost one: their self times sum to it
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx(dur["fit.render"])
    sp, _ = spans.events(cpu_profile, ("voge.", "fit."))
    assert spans.covered(sp, STEPS) == {sp[0][1]: pytest.approx(dur["fit.render"])}
    once, _ = spans.read(cpu_profile, 1, ("voge.",))
    assert once["voge.coarse"]["calls"] == STEPS
    assert once["voge.coarse"]["self_ms"] == pytest.approx(STEPS * rows["voge.coarse"]["self_ms"])


def test_launches_go_to_the_innermost_span_on_their_thread():
    sp = [("voge.render", 1, 0.0, 100.0), ("voge.select", 1, 10.0, 50.0),
          ("voge.select.gather", 1, 20.0, 30.0), ("voge.fine_bwd", 2, 40.0, 90.0)]
    launches = [(1, 5.0, "a", 1.0),          # render's own
                (1, 25.0, "gather", 2.0),    # the innermost of three
                (1, 30.0, "gather", 2.0),    # at the span's end: still inside
                (1, 45.0, "k2", 4.0),        # back in select
                (2, 45.0, "k3", 8.0),        # another thread's span at the same time
                (1, 95.0, "b", 1.0),         # render again, after its children
                (1, 150.0, "late", 3.0),     # after every span
                (None, None, "lost", 5.0),   # no runtime call found
                (3, 45.0, "other", 6.0)]     # a thread with no span
    assert spans.owners(sp, launches) == [
        "voge.render", "voge.select.gather", "voge.select.gather", "voge.select",
        "voge.fine_bwd", "voge.render", None, None, None]
    rows, outside = spans.table(sp, launches, 2)
    assert rows["voge.select.gather"] == {"calls": 0.5, "self_ms": 0.005, "device_ms": 0.002,
                                          "launches": 1.0}
    assert rows["voge.render"]["launches"] == 1.0 and rows["voge.render"]["device_ms"] == 0.001
    assert rows["voge.render"]["self_ms"] == pytest.approx((100 - 40) / 1e3 / 2)
    assert rows["voge.select"]["self_ms"] == pytest.approx((40 - 10) / 1e3 / 2)
    assert rows["voge.fine_bwd"]["device_ms"] == 0.004
    assert sorted(outside) == [("late", 3.0), ("lost", 5.0), ("other", 6.0)]
    # each thread's outermost spans, nested ones counted once
    assert spans.covered(sp + [("fit.sgd", 1, 120.0, 130.0)], 2) == {
        1: pytest.approx(110 / 1e3 / 2), 2: pytest.approx(50 / 1e3 / 2)}


def test_a_span_the_stretch_does_not_hold_reads_none():
    rows = {"voge.select": {"calls": 1.0, "self_ms": 0.25, "device_ms": 0.0, "launches": 0.0}}
    assert spans.value(rows, ["voge.similarity"], "self_ms") is None
    assert spans.value(rows, ["voge.select", "voge.select.cull"], "self_ms") == 0.25
    # a span that launched nothing has no device time to read
    assert spans.value(rows, ["voge.select"], "device_ms") is None
    empty = spans.layers({}, {}, 10)
    assert set(empty) == {"coarse.read_wait_ms", "host_reads_per_step", "coarse.row_fill_pct",
                          "glue.host_ms", "coarse.host_ms", "select.host_ms",
                          "fine_bwd.host_ms", "attr.host_ms", "gather.device_ms",
                          "similarity.device_ms"}
    assert all(v is None for v in empty.values())


def test_layers_from_a_table_and_the_counts():
    row = lambda ms, dev=0.0: {"calls": 1.0, "self_ms": ms, "device_ms": dev, "launches": 1.0}
    rows = {"voge.render": row(0.5), "voge.coarse": row(0.2), "voge.coarse.read": row(0.1),
            "voge.select": row(0.3, 1.4), "voge.select.table": row(0.05),
            "voge.select.gather": row(0.04, 0.6), "voge.fine_bwd": row(0.25)}
    counts = {"host_reads": 20, "coarse.slots": 1000, "coarse.members": 250}
    got = spans.layers(rows, counts, 10)
    assert got["host_reads_per_step"] == 2.0 and got["coarse.row_fill_pct"] == 25.0
    assert got["coarse.read_wait_ms"] == 0.1 and got["coarse.host_ms"] == 0.2
    assert got["select.host_ms"] == pytest.approx(0.39) and got["gather.device_ms"] == 0.6
    assert got["glue.host_ms"] == 0.5 and got["fine_bwd.host_ms"] == 0.25
    assert got["attr.host_ms"] is None and got["similarity.device_ms"] is None
    # no coarse stage (the global route): no host reads to read per step
    assert spans.layers({"voge.select": row(0.3)}, {"coarse.slots": 0}, 10)[
        "host_reads_per_step"] is None
