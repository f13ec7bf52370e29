"""The roofline's byte and operation counts, the layers' kernel patterns and
the trace's reading, on hand-built fragments."""
import pytest
import torch

from portbench import harness, roofline, tracing
from portbench.layers import device_ms, matches, roofline_pct
from portbench.reference.render import counts

IDS = torch.tensor([[3, 1, -1], [-1, -1, -1], [0, 2, 4], [5, -1, -1]])


def render(**kw):
    r = dict(counts(IDS), P=6, pairs=9, weight=1.0, d_select=0, bwd=None, d_bwd=0,
             rays_grad=False, merge_d=0, dw=False, dattr=False)
    r.update(kw)
    return r


def test_counts_of_selections():
    assert counts(IDS) == dict(n_pix=4, K=3, valid=6.0, valid_sq=4 + 9 + 1.0, pix_valid=3.0)


def test_select_bound_by_hand():
    # rays 4 x 12 B, Gaussians 6 x 48 B, 3 outputs of 4 x 3 slots x 4 B
    by = 4 * 12 + 6 * 48 + 3 * 12 * 4
    ops = 9 * 49 + 14 * 6
    assert roofline.select_ms([render()]) == pytest.approx(
        max(by / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)
    # a backward keeps act and dsd too; an attribute width composites
    by_b = by + 2 * 12 * 4 + 4 * 3 * 4 + 6 * 3 * 4
    assert roofline.select_ms([render(bwd="full", d_select=3)]) == pytest.approx(
        max(by_b / 3.35e12, (ops + 6 * 6) / 67e12) * 1e3, rel=1e-12)


def test_attr_bound_by_hand():
    d = 2
    ids, rows = 12 * 4, 6 * d * 4
    by = ids + 6 * 4 + rows + 4 * d * 4
    assert roofline.attr_ms([render(merge_d=d)]) == pytest.approx(
        max(by / 3.35e12, 6 * 2 * d / 67e12) * 1e3, rel=1e-12)
    by_dw = by + 2 * ids + rows + 3 * d * 4
    assert roofline.attr_ms([render(merge_d=d, dw=True, weight=0.5)]) == pytest.approx(
        0.5 * max(by_dw / 3.35e12, 6 * 4 * d / 67e12) * 1e3, rel=1e-12)
    assert roofline.attr_ms([render()]) is None


def test_fine_bwd_bound_by_hand():
    by = 4 * 12 + 5 * 12 * 4 + 6 * 48 + 4 * 12
    ops = 14 * 18 + 6 * 40
    assert roofline.fine_bwd_ms([render(bwd="rays", rays_grad=True)]) == pytest.approx(
        max(by / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)
    assert roofline.fine_bwd_ms([render()]) is None


@pytest.mark.parametrize("name,patterns,hit", [
    ("void (anonymous namespace)::rows_kernel<4>(int const*)", ("rows_kernel",), True),
    ("void (anonymous namespace)::emit_rows_kernel<4>(int const*)", ("rows_kernel",), False),
    ("void (anonymous namespace)::cull_rows_kernel(float const*)", ("rows_kernel",), False),
    ("void attr_scatter_kernel<2>(float*)", ("scatter_kernel",), False),
    ("void attr_scatter_kernel<2>(float*)", ("attr_scatter_kernel",), True),
])
def test_patterns_match_whole_identifiers(name, patterns, hit):
    assert matches(name, patterns) is hit


def trace():
    t = tracing.Trace(steps=2, window_s=0.01)
    t.kernels = {"void (anonymous namespace)::fine_select_kernel<1>(x)": (300.0, 2),
                 "void at::native::vectorized_gather_kernel<16, long>(x)": (100.0, 4),
                 "Memset (Device)": (10.0, 2)}
    t.busy_s = 410e-6
    return t


def test_layer_metrics_from_a_trace():
    ctx = harness.Context(trace(), [render()], {"select.device_ms": ("fine_select_kernel",)},
                          window_ms=5.0)
    assert device_ms(ctx, ("fine_select_kernel",)) == pytest.approx(0.15)
    assert device_ms(ctx, ("fold_kernel",)) is None
    assert harness.metric_module("torch_glue.device_ms").read(ctx) == pytest.approx(0.055)
    assert harness.metric_module("launches_per_step").read(ctx) == 4
    assert harness.metric_module("device_idle_pct").read(ctx) == pytest.approx(95.9)
    assert roofline_pct(ctx, ("fine_select_kernel",), roofline.select_ms) == pytest.approx(
        100 * roofline.select_ms([render()]) / 0.15)
    assert harness.metric_module("attr_roofline").read(ctx) is None


def test_short_names():
    assert tracing.short_name("void (anonymous namespace)::fold_kernel<3, 2>(float const*)") \
        == "fold_kernel<3, 2>"
    assert tracing.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def fake_prof(events):
    """A stand-in for a finished ``torch.profiler.profile`` (its ``events``)."""
    from types import SimpleNamespace as NS

    CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    evs = [NS(device_type=CUDA if dev else CPU, is_user_annotation=ann, name=name, thread=1,
              time_range=NS(start=s, end=e)) for dev, ann, name, s, e in events]
    return NS(events=lambda: evs)


def test_trace_read_from_device_events():
    prof = fake_prof([(True, False, "k1", 0.0, 10.0), (True, False, "k2", 5.0, 20.0),
                      (True, True, "fit.sgd", 0.0, 100.0), (True, False, "k1", 60.0, 70.0),
                      (False, False, "aten::add", 0.0, 1.0)])
    t = tracing.read(prof, 2, 1e-4)
    assert t.kernels == {"k1": (20.0, 2), "k2": (15.0, 1)}
    assert t.busy_s == pytest.approx(30e-6)
    with pytest.raises(RuntimeError):
        tracing.read(fake_prof([(False, False, "aten::add", 0.0, 1.0)]), 1, 1.0)


def test_idle_gaps_labelled_by_host_op():
    prof = fake_prof([(True, False, "k1", 0.0, 10.0), (True, False, "k2", 30.0, 40.0),
                      (True, False, "k3", 50.0, 60.0),
                      (False, False, "fit.render", 0.0, 43.0), (False, False, "aten::empty", 12.0, 28.0),
                      (False, False, "cudaLaunchKernel", 44.0, 55.0)])
    assert tracing.idle_gaps(prof, "fit.") == {"fit.render / aten::empty": 20.0,
                                               "outside the spans / cudaLaunchKernel": 10.0}


@pytest.mark.parametrize("mppb,merged", [(None, False), (-1, True)])
def test_fit_work_follows_the_route(mppb, merged):
    """The colours are merged in the select on the compacted route and by
    the attribute merge on the global one (no coarse stage)."""
    from portbench.entries.fit import Entry

    e = Entry.__new__(Entry)
    e.mppb, e.traffic = mppb, {"leaves": ["verts", "colors"]}
    (r,) = e.work([dict(counts(IDS), P=6, pairs=9)])
    got = (r["d_select"], r["d_bwd"], r["merge_d"], r["dw"], r["dattr"])
    assert got == ((0, 0, 3, True, True) if merged else (3, 3, 0, False, False))
    assert (roofline.attr_ms([r]) is None) is not merged
