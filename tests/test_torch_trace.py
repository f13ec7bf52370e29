"""The port's tracing (``voge_tpu_torch.trace``): off, its spans are one
shared no-op and no counter moves; on, a render's spans nest by layer under a
CPU ``torch.profiler`` and its counters hold what the code did (the coarse
stage's host reads counted against a spy on every read of a tensor's values,
its re-emissions, its slots and members).  On the card (marker ``cuda``):
torch's sync debug mode counts exactly ``host_reads`` synchronising calls in
one ``render_pipeline`` (whose select counts the per-slot copy of rows it
spares), and the global entry's two-level cull counts its launches, its
level-1 pairs and the rows it keeps.  No JAX here, so the card
runs this file too:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trace.py
"""
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import voge_tpu_torch as vt
from voge_tpu_torch import trace
from voge_tpu_torch.models.pose import feature_similarity
from voge_tpu_torch.ops import coarse as tcoarse
from voge_tpu_torch.ops import fine
from voge_tpu_torch.rays import camera_rays

torch.set_num_threads(2)
HW = (32, 32)


def _scene(device="cpu", P=300):
    """Two cameras over 300 seeded anisotropic Gaussians with colours."""
    g = torch.Generator().manual_seed(0)
    verts = (torch.rand(P, 3, generator=g) * 2 - 1) * 0.8
    a = torch.rand(P, 3, 3, generator=g) * 2 - 1
    sig = (a @ a.transpose(1, 2) + 2 * torch.eye(3)) * 50
    colors = torch.rand(P, 3, generator=g)
    R, T = vt.look_at_view_transform(dist=[4.0, 4.5], elev=[10.0, 20.0], azim=[30.0, 50.0],
                                     device="cpu")
    cams = (R, T, torch.full((2, 2), 50.0), torch.full((2, 2), 16.0))
    return tuple(x.to(device) for x in (verts, sig, colors, *cams))


def _render(verts, sig, colors, *cams, **kw):
    return vt.render_pipeline(verts, sig, *cams, image_size=HW, max_assign=8, attrs=colors, **kw)


def _renderer(verts, sig, colors, R, T, focal, pp):
    """``GaussianRenderer`` over the same scene and cameras: (renderer,
    scene, its call's camera kwargs)."""
    cams = vt.PerspectiveCameras(focal_length=focal, principal_point=pp, image_size=(HW,),
                                 device=verts.device)
    renderer = vt.GaussianRenderer(cams, vt.GaussianRenderSettings(image_size=HW,
                                                                   max_assign=8))
    return renderer, vt.GaussianMeshesNaive(verts, sig), dict(R=R, T=T)


def _wide_inputs():
    """One camera over 60 Gaussians of which two outgrow the emission
    window: with a global list of one, the stage emits again, wider."""
    rng = np.random.RandomState(77)
    P = 60
    mus = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2.0 * np.eye(3, dtype=np.float32)) * 100.0
    isig[3] = isig[7] = np.eye(3, dtype=np.float32) * 0.7
    R, T = vt.look_at_view_transform(dist=[4.0], elev=[10.0], azim=[30.0], device="cpu")
    focal, pp = torch.tensor([[50.0, 50.0]]), torch.tensor([[16.0, 16.0]])
    hw = (33, 47)
    _, origins = camera_rays(R, T, focal, pp, hw)
    pts = torch.as_tensor(mus)[None] - origins[:, None, :]
    return (R, T, focal, pp, pts, torch.as_tensor(isig)[None]), hw


class _HostReads:
    """Count the reads of tensor values into Python."""
    NAMES = ("tolist", "item", "__int__", "__float__", "__bool__", "__index__")

    def __enter__(self):
        self.n = 0
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def spy(fn):
            def read(t, *a, **k):
                self.n += 1
                return fn(t, *a, **k)
            return read
        for k, fn in self.saved.items():
            setattr(torch.Tensor, k, spy(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(torch.Tensor, k, fn)


def _voge_events(prof):
    """(name, names of the program spans enclosing it) of every program span
    the profiler recorded."""
    out = []
    for ev in prof.events():
        if ev.name.startswith("voge."):
            up, p = [], ev.cpu_parent
            while p is not None:
                if p.name.startswith("voge."):
                    up.append(p.name)
                p = p.cpu_parent
            out.append((ev.name, up))
    return out


def test_off_span_is_one_shared_noop_and_nothing_counts():
    assert not trace.enabled()
    s = trace.span("voge.render")
    assert s is trace.span("voge.select") and type(s).__slots__ == ()
    with s as entered:
        assert entered is None
    trace.reset()
    trace.count("host_reads")
    trace.count_device("coarse.members", torch.ones(3, dtype=torch.int32))
    assert trace.counts() == {}
    scene = _scene()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(*scene)
    assert trace.counts() == {} and _voge_events(prof) == []


def test_tracing_restores_the_switch_and_keeps_the_counts():
    with trace.tracing():
        assert trace.enabled()
        trace.count("a", 2)
        trace.count("a")
        trace.count_device("b", torch.tensor([1, 2, 3], dtype=torch.int32))
        trace.count_device("b", torch.tensor([4]))
    assert not trace.enabled()
    assert trace.counts() == {"a": 3, "b": 10}
    with trace.tracing():
        assert trace.counts() == {}
    trace.enable()
    try:
        with trace.tracing():
            pass
        assert trace.enabled()
    finally:
        trace.disable()


def test_a_compacted_render_nests_its_spans_by_layer():
    verts, sig, colors, *cams = _scene()
    verts.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.tracing():
        frag = _render(verts, sig, colors, *cams)
        (frag.vert_weight.sum() + frag.attr_img.sum()).backward()
    spans = _voge_events(prof)
    names = {n for n, _ in spans}
    assert {"voge.render", "voge.coarse", "voge.coarse.read", "voge.grouping", "voge.select",
            "voge.select.table", "voge.fine_bwd"} <= names
    # K2 reads the candidates' rows from the table by id: no gather, no cull
    assert "voge.select.gather" not in names and "voge.select.cull" not in names
    within = {n: up for n, up in spans}
    assert within["voge.render"] == []
    assert within["voge.coarse"] == ["voge.render"]
    assert within["voge.coarse.read"] == ["voge.coarse", "voge.render"]
    assert within["voge.grouping"] == ["voge.coarse", "voge.render"]
    assert within["voge.select"] == ["voge.render"]
    assert within["voge.select.table"] == ["voge.select", "voge.render"]
    assert within["voge.fine_bwd"] == []


def test_the_global_route_and_the_merge_and_the_similarity_have_their_spans():
    verts, sig, colors, *cams = _scene(P=120)
    verts.requires_grad_(True)
    colors.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.tracing():
        frag = _render(verts, sig, colors, *cams, max_point_per_bin=-1)
        frag.attr_img.sum().backward()
        img = vt.interpolate_attr(frag, colors.detach())
        feature_similarity(img, img.flip(0))
    seen = {(n, tuple(up)) for n, up in _voge_events(prof)}
    assert seen == {
        ("voge.render", ()), ("voge.select", ("voge.render",)),
        ("voge.select.table", ("voge.select", "voge.render")),
        # the render merges the colours; interpolate_attr again, outside it
        ("voge.attr", ("voge.render",)), ("voge.attr", ()), ("voge.attr", ("voge.attr",)),
        ("voge.fine_bwd", ()), ("voge.attr_bwd", ()), ("voge.similarity", ())}
    assert trace.counts().get("host_reads", 0) == 0


def test_counters_of_a_compacted_render():
    verts, sig, colors, *cams = _scene()
    with trace.tracing():
        frag = _render(verts, sig, colors, *cams)
    n = trace.counts()
    c = fine.compact_candidates(*cams, verts[None] - camera_rays(*cams, HW)[1][:, None],
                                2 * sig[None].expand(2, -1, 3, 3), HW, 0.01, 8)
    assert n["host_reads"] == 1 and "coarse.reemits" not in n
    assert n["coarse.slots"] == c.pos_c.numel()
    assert n["coarse.members"] == int(c.counts_c.sum()) <= n["coarse.slots"]
    assert n["coarse.overflow"] == int(frag.overflow_points) == 0
    # the plain versions ran: no kernel launch is counted, nor the copy K2 spares
    assert not [k for k in n if k.startswith("launch.")]
    assert "select.copy_bytes_avoided" not in n
    # GaussianRenderer reads its four camera tensors besides, to key its context
    renderer, g, kw = _renderer(verts, sig, colors, *cams)
    with trace.tracing():
        renderer(g, **kw)
    assert trace.counts()["host_reads"] == 5


@pytest.mark.parametrize("route", ["staged", "sorted"])
@pytest.mark.parametrize("n_globals,row_align,reemits", [(64, 8, 0), (1, 8, 1), (1, 0, 0)])
def test_host_reads_count_every_read_and_the_reemission(route, n_globals, row_align, reemits):
    """The counter equals a spy on every read of a tensor's values: one a
    render (the staged route), two when it emits again; the int64 route reads
    once more to size the wider window; fixed rows read nothing."""
    args, hw = _wide_inputs()
    win = tcoarse.emission_geometry(args[4].shape[1], hw, 10)[-1]
    fn = tcoarse._emit_candidates_sorted if route == "sorted" else tcoarse._emit_candidates
    with trace.tracing(), _HostReads() as spy:
        out = fn(*args, hw, 0.01, 10, 64, n_globals, row_align, False, win)
    n = trace.counts()
    assert n.get("host_reads", 0) == spy.n
    assert n.get("coarse.reemits", 0) == reemits
    want = {(64, 8): 1, (1, 8): 2 + (route == "sorted"), (1, 0): 0}[n_globals, row_align]
    assert spy.n == want
    assert int(out[4].sum()) == (1 if row_align == 0 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,reads", [("render_pipeline", 1), ("GaussianRenderer", 5)])
def test_sync_debug_mode_counts_host_reads_on_the_card(entry, reads):
    """On the card each counted host read is a synchronising call and there
    is no other in one compacted render, by either entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("cuda")
    if entry == "render_pipeline":
        render = lambda: _render(*scene)
    else:
        renderer, g, kw = _renderer(*scene)
        render = lambda: renderer(g, **kw)
    render()                                     # builds and loads the kernels
    torch.cuda.synchronize()
    with trace.tracing(), warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            render()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
    n = trace.counts()
    assert n["host_reads"] == len(syncs) == reads, [str(w.message) for w in syncs]
    assert n["launch.fine_select"] == 1 and n["launch.emit_rows"] == 1
    assert n["coarse.members"] <= n["coarse.slots"]
    # K2 staged its rows by id: the copy of 64 bytes a slot was not made
    assert n["select.copy_bytes_avoided"] == 64 * n["coarse.slots"]


@pytest.mark.cuda
@pytest.mark.parametrize("two", [True, False])
def test_cull_counters_of_the_global_entry(monkeypatch, two):
    """The two-level cull's counters on the card: its level 1 and its
    super-tiles' cones launched once a call, ``cull.level1_pairs`` the
    super-tiles times P, ``cull.kept_rows`` the bits set in its mask (a
    device sum); the single-level route counts none of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from voge_tpu_torch.ops import cuda_fine as cf

    monkeypatch.setattr(cf, "_TWO_LEVEL_MIN_PAIRS", 0 if two else 1 << 62)
    monkeypatch.setattr(cf, "_SUPER", 1)
    B, P = 2, 3000
    verts, sig, _, R, T, focal, pp = _scene("cuda", P)
    rays, origins = camera_rays(R, T, focal, pp, HW)
    table = fine.feature_table(verts[None] - origins[:, None, :],
                               (2.0 * sig)[None].expand(B, -1, 3, 3))
    thr = -np.log(0.01 + 1e-10)
    with trace.tracing():
        cf.fine_select_global(rays, table, None, thr, 8, 4, 1.0)
    n = trace.counts()
    assert n["launch.fine_select_global"] == 1 and n["launch.cull_rows"] == 1
    if not two:
        assert not [k for k in n if k.startswith("cull.") or k in (
            "launch.cull_lists", "launch.super_cones")]
        return
    TH, TW = (HW[0] - 1) // 8 + 1, (HW[1] - 1) // 16 + 1          # S = 1: a block each
    mask = cf.cull_lists(cf.cull_rows(table, thr), cf.two_level_cones(rays)[1], B, P)
    kept = int(cf.mask_bits(mask, P).sum())
    assert n["launch.cull_lists"] == 1 and n["launch.super_cones"] == 1
    assert n["cull.level1_pairs"] == B * TH * TW * P
    assert n["cull.kept_rows"] == kept and 0 < kept < B * TH * TW * P
