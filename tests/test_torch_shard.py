"""``voge_tpu_torch.parallel.shard`` on meshes of logical CPU shards (a
device list naming ``cpu`` eight times) against ``voge_tpu.parallel`` on its
eight virtual CPU devices (``tests/conftest.py``), at
``tests/test_parallel.py``'s shapes and tolerances:

- against ``voge_tpu``'s sharded render: the (8, 1) render, the ring (2, 4)
  render and gradients, the replicated-scene render with
  ``interpolate_attr_sharded`` / ``sample_features_sharded``, the DP training
  step;
- against ``voge_tpu``'s single-device ``render_pipeline`` (which its own
  tests hold equal to its sharded one): the (2, 4) and (1, 8) all-gather
  renders and gradients, and the binned render (``max_point_per_bin=3000``,
  N = 800) and its gradients;
- the merge's tie order and fill, padded Gaussians, ``DataParallelBatchifier``
  and ``make_mesh``'s device rule.

Tolerances (``tests/test_parallel.py``): ``vert_index`` flips < 1e-3;
weights on exactly matching pixels rtol 1e-4 / atol 5e-5; gradients rtol and
atol 4e-3; attribute images and sampled features 1e-4.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter import Cuboid
from voge_tpu.parallel import (
    DataParallelBatchifier as JDataParallelBatchifier,
    interpolate_attr_sharded as j_interp_sharded,
    make_mesh as j_make_mesh,
    render_pipeline_sharded as j_render_sharded,
    sample_features_sharded as j_sample_sharded,
)
from voge_tpu.renderer import get_overflow_points as j_overflow
from voge_tpu.renderer import render_pipeline as j_render
import voge_tpu_torch as vt
from voge_tpu_torch.parallel import (
    DataParallelBatchifier,
    interpolate_attr_sharded,
    make_mesh,
    render_pipeline_sharded,
    sample_features_sharded,
)
from voge_tpu_torch.parallel import shard

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _scene_and_cams(B=8, N=160, pad=True):
    """``tests/test_parallel.py``'s scene as numpy: a cuboid of N requested
    Gaussians (padded to a multiple of 8 with Gaussians at 100.0, far from
    every camera), B cameras at 64x64 (focal 80, principal 32)."""
    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), N, percentage=0.6, as_obj=True)
    R, T = look_at_view_transform(dist=[5.0] * B, elev=list(np.linspace(0, 40, B)),
                                  azim=list(np.linspace(-60, 60, B)))
    verts, sigmas = np.asarray(g.verts), np.asarray(g.sigmas)
    n = verts.shape[0]
    if pad:
        n_pad = (n + 7) // 8 * 8
        verts = np.pad(verts, ((0, n_pad - n), (0, 0)), constant_values=100.0)
        sigmas = np.pad(sigmas, ((0, n_pad - n),), constant_values=1.0)
    cams = (np.asarray(R, np.float32), np.asarray(T, np.float32),
            np.full((B, 2), 80.0, np.float32), np.full((B, 2), 32.0, np.float32))
    return verts.astype(np.float32), sigmas.astype(np.float32), cams, n


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _hold_render(ft, ij, wj, exact_min=None):
    """Flips below 1e-3 and weights on exactly matching pixels at
    rtol 1e-4 / atol 5e-5."""
    it = ft.vert_index.numpy()
    assert it.dtype == np.int32 and it.shape == ij.shape
    assert (it != ij).mean() < 1e-3
    exact = (it == ij).all(-1)
    if exact_min is not None:
        assert exact.mean() > exact_min
    np.testing.assert_allclose(ft.vert_weight.detach().numpy()[exact], np.asarray(wj)[exact],
                               rtol=1e-4, atol=5e-5)
    np.testing.assert_array_equal(ft.valid_num.numpy(), (it >= 0).sum(-1))
    return exact


def test_sharded_render_8x1_matches_voge_tpu_sharded():
    verts, sigmas, cams, _ = _scene_and_cams(B=8)
    kw = dict(image_size=(64, 64), max_assign=8, max_point_per_bin=-1)
    fj = j_render_sharded(jnp.asarray(verts), jnp.asarray(sigmas), *cams,
                          mesh=j_make_mesh(("data", "model"), (8, 1)), **kw)
    ft = render_pipeline_sharded(_t(verts), _t(sigmas), *map(_t, cams),
                                 mesh=make_mesh(("data", "model"), (8, 1), devices=CPU8), **kw)
    _hold_render(ft, np.asarray(fj.vert_index), fj.vert_weight)
    np.testing.assert_allclose(ft.vert_weight.sum(-1).numpy(),
                               np.asarray(fj.vert_weight).sum(-1), rtol=1e-4, atol=0.02)
    assert int(ft.overflow_points) == 0 == int(j_overflow(fj))


def test_ring_render_matches_voge_tpu_ring():
    verts, sigmas, cams, _ = _scene_and_cams(B=4)
    kw = dict(image_size=(64, 64), max_assign=8, max_point_per_bin=-1, ring=True)
    fj = j_render_sharded(jnp.asarray(verts), jnp.asarray(sigmas), *cams,
                          mesh=j_make_mesh(("data", "model"), (2, 4)), **kw)
    ft = render_pipeline_sharded(_t(verts), _t(sigmas), *map(_t, cams),
                                 mesh=make_mesh(("data", "model"), (2, 4), devices=CPU8), **kw)
    _hold_render(ft, np.asarray(fj.vert_index), fj.vert_weight, exact_min=0.999)


def _sum_w2_t(mesh_shape, ring, cams, kw):
    mesh = make_mesh(("data", "model"), mesh_shape, devices=CPU8)
    return lambda v, s: (render_pipeline_sharded(v, s, *map(_t, cams), mesh=mesh, ring=ring,
                                                 **kw).vert_weight ** 2).sum()


def test_ring_gradients_match_voge_tpu_ring():
    """Gradients through the ring (the blocks' moves run back in autograd)
    against ``jax.grad`` through ``voge_tpu``'s ppermute ring; the padded
    Gaussians' gradient is zero."""
    verts, sigmas, cams, n = _scene_and_cams(B=2)
    kw = dict(image_size=(32, 32), max_assign=6, max_point_per_bin=-1)
    jm = j_make_mesh(("data", "model"), (2, 4))
    loss_j = lambda v, s: jnp.sum(j_render_sharded(v, s, *cams, mesh=jm, ring=True,
                                                   **kw).vert_weight ** 2)
    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(verts), jnp.asarray(sigmas))
    v, s = _t(verts, True), _t(sigmas, True)
    gt = torch.autograd.grad(_sum_w2_t((2, 4), True, cams, kw)(v, s), (v, s))
    for a, b in zip(gt, gj):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=4e-3, atol=4e-3)
        assert a.abs().sum() > 0 and (a[n:] == 0).all()


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_all_gather_render_and_gradients_match_single_device(mesh_shape):
    """The all-gather route on (2, 4) and (1, 8) against ``voge_tpu``'s
    single-device render; the gradients at B = 4, 32x32, K = 6 against its
    ``jax.grad``, leaving out Gaussians of flipped pixels as
    ``tests/test_parallel.py`` does."""
    verts, sigmas, cams, _ = _scene_and_cams(B=8)
    kw = dict(image_size=(64, 64), max_assign=8, max_point_per_bin=-1)
    f1 = j_render(jnp.asarray(verts), jnp.asarray(sigmas), *cams, **kw)
    ft = render_pipeline_sharded(_t(verts), _t(sigmas), *map(_t, cams),
                                 mesh=make_mesh(("data", "model"), mesh_shape, devices=CPU8),
                                 **kw)
    _hold_render(ft, np.asarray(f1.vert_index), f1.vert_weight)

    verts, sigmas, cams, _ = _scene_and_cams(B=4)
    kw = dict(image_size=(32, 32), max_assign=6, max_point_per_bin=-1)
    loss_j = lambda v, s: jnp.sum(j_render(v, s, *cams, **kw).vert_weight ** 2)
    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(verts), jnp.asarray(sigmas))
    v, s = _t(verts, True), _t(sigmas, True)
    loss_t = _sum_w2_t(mesh_shape, False, cams, kw)
    gt = torch.autograd.grad(loss_t(v, s), (v, s))
    i1 = np.asarray(j_render(jnp.asarray(verts), jnp.asarray(sigmas), *cams, **kw).vert_index)
    i2 = render_pipeline_sharded(_t(verts), _t(sigmas), *map(_t, cams),
                                 mesh=make_mesh(("data", "model"), mesh_shape, devices=CPU8),
                                 **kw).vert_index.numpy()
    flipped = (i1 != i2).any(-1)
    assert flipped.mean() < 1e-3
    excluded = {int(x) % verts.shape[0] for b, i, j in np.argwhere(flipped)
                for x in list(i1[b, i, j]) + list(i2[b, i, j]) if x >= 0}
    keep = np.array([i not in excluded for i in range(verts.shape[0])])
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep], rtol=4e-3, atol=4e-3)
    # two runs equal to the bit
    g2 = torch.autograd.grad(loss_t(v, s), (v, s))
    assert all(torch.equal(a, b) for a, b in zip(gt, g2))


def test_binned_render_and_gradients_match_single_device():
    """The coarse stage per model shard (``max_point_per_bin=3000``, N =
    800 requested) on (2, 4) against ``voge_tpu``'s single-device binned
    render, whose overflow is 0; each model shard bins only its own
    Gaussians, and the port's sharded overflow is 0 too."""
    verts, sigmas, cams, _ = _scene_and_cams(B=8, N=800)
    kw = dict(image_size=(64, 64), max_assign=8, max_point_per_bin=3000)
    mesh = make_mesh(("data", "model"), (2, 4), devices=CPU8)
    f1 = j_render(jnp.asarray(verts), jnp.asarray(sigmas), *cams, **kw)
    assert int(j_overflow(f1)) == 0
    ft = render_pipeline_sharded(_t(verts), _t(sigmas), *map(_t, cams), mesh=mesh, **kw)
    assert int(ft.overflow_points) == 0
    _hold_render(ft, np.asarray(f1.vert_index), f1.vert_weight, exact_min=0.999)

    cams2 = tuple(x[:2] for x in cams)
    loss_j = lambda v, s: jnp.sum(j_render(v, s, *cams2, **kw).vert_weight ** 2)
    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(verts), jnp.asarray(sigmas))
    v, s = _t(verts, True), _t(sigmas, True)
    gt = torch.autograd.grad(_sum_w2_t((2, 4), False, cams2, kw)(v, s), (v, s))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=4e-3, atol=4e-3)


def test_replicated_scene_render_interpolate_and_sample_match_voge_tpu():
    """``model_axis=None`` on an (8,) mesh: fragments, ``interpolate_attr_sharded``
    and ``sample_features_sharded`` against ``voge_tpu``'s on its eight
    devices, and the helpers against the single-device ones."""
    verts, sigmas, cams, _ = _scene_and_cams(B=8, pad=False)
    N, B = verts.shape[0], 8
    kw = dict(image_size=(64, 64), max_assign=8, max_point_per_bin=-1)
    jm = j_make_mesh(("data",), (8,))
    fj = j_render_sharded(jnp.asarray(verts), jnp.asarray(sigmas), *cams, mesh=jm,
                          model_axis=None, **kw)
    mesh = make_mesh(("data",), (8,), devices=CPU8)
    ft = render_pipeline_sharded(_t(verts), _t(sigmas), *map(_t, cams), mesh=mesh,
                                 model_axis=None, **kw)
    assert ft.scene_size == N and int(ft.overflow_points) == 0
    exact = _hold_render(ft, np.asarray(fj.vert_index), fj.vert_weight)

    rng = np.random.RandomState(0)
    colors = rng.uniform(0, 1, size=(N, 3)).astype(np.float32)
    img_j = j_interp_sharded(fj, jnp.asarray(colors), jm)
    img_t = interpolate_attr_sharded(ft, _t(colors), mesh)
    np.testing.assert_allclose(img_t.numpy()[exact], np.asarray(img_j)[exact],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(img_t, vt.interpolate_attr(ft, _t(colors)), rtol=0, atol=1e-6)
    per_cam = np.tile(colors, (B, 1))
    torch.testing.assert_close(interpolate_attr_sharded(ft, _t(per_cam), mesh), img_t,
                               rtol=0, atol=0)

    image = rng.uniform(0, 1, size=(B, 64, 64, 3)).astype(np.float32)
    feat_j, wsum_j = j_sample_sharded(fj, jnp.asarray(image), B * N, jm)
    feat_t, wsum_t = sample_features_sharded(ft, _t(image), B * N, mesh)
    assert feat_t.shape == (B * N, 3) and wsum_t.shape == (B * N,)
    np.testing.assert_allclose(wsum_t.numpy(), np.asarray(wsum_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), rtol=1e-4, atol=1e-4)
    feat_1, wsum_1 = vt.sample_features(ft, _t(image), n_vert=B * N)
    torch.testing.assert_close(feat_t, feat_1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wsum_t, wsum_1, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="n_vert == B"):
        sample_features_sharded(ft, _t(image), N, mesh)


def test_dp_training_step_gradients_match_voge_tpu():
    """One DP step through the replicated-scene render and
    ``interpolate_attr_sharded``: the (verts, colours) gradients against
    ``voge_tpu``'s same step on its eight devices, and two runs equal to
    the bit."""
    verts, sigmas, cams, _ = _scene_and_cams(B=8, pad=False)
    N = verts.shape[0]
    kw = dict(image_size=(32, 32), max_assign=6, max_point_per_bin=-1)
    rng = np.random.RandomState(1)
    colors = rng.uniform(0, 1, size=(N, 3)).astype(np.float32)
    target = rng.uniform(0, 1, size=(8, 32, 32, 3)).astype(np.float32)
    jm = j_make_mesh(("data",), (8,))

    def loss_j(v, c):
        f = j_render_sharded(v, jnp.asarray(sigmas), *cams, mesh=jm, model_axis=None, **kw)
        return jnp.mean((j_interp_sharded(f, c, jm) - target) ** 2)

    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(verts), jnp.asarray(colors))
    mesh = make_mesh(("data",), (8,), devices=CPU8)
    v, c = _t(verts, True), _t(colors, True)

    def grads():
        f = render_pipeline_sharded(v, _t(sigmas), *map(_t, cams), mesh=mesh, model_axis=None,
                                    **kw)
        loss = ((interpolate_attr_sharded(f, c, mesh) - _t(target)) ** 2).mean()
        return torch.autograd.grad(loss, (v, c))

    gt = grads()
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=4e-3, atol=4e-3)
    assert all(torch.equal(a, b) for a, b in zip(gt, grads()))


def _lists(ids, lens):
    idx = torch.tensor(ids, dtype=torch.int32)[None]
    length = torch.tensor(lens, dtype=torch.float32)[None]
    return idx, length, length * 10, length * 100


def test_merge_keeps_the_lower_global_position_on_a_tie():
    """Two shards' lists holding one length each: shard-major concatenation,
    and the stable sort keeps the lower position first (``lax.top_k``'s tie
    order), so the lower global id wins the last slot."""
    a = _lists([3, 7, -1], [1.0, 2.0, 1e10])
    b = _lists([12, 15, -1], [2.0, 2.0, 1e10])
    idx, length, act, dsd = shard._merge_topk((a, b), 3)
    assert idx.tolist() == [[3, 7, 12]] and length.tolist() == [[1.0, 2.0, 2.0]]
    assert act.tolist() == [[10.0, 20.0, 20.0]] and dsd.tolist() == [[100.0, 200.0, 200.0]]
    idx, *_ = shard._merge_topk((b, a), 3)
    assert idx.tolist() == [[3, 12, 15]]
    # lax.top_k on the same concatenations
    for parts in ((a, b), (b, a)):
        neg = -np.concatenate([p[1].numpy() for p in parts], -1)
        ids = np.concatenate([p[0].numpy() for p in parts], -1)
        args = np.asarray(jax.lax.top_k(jnp.asarray(neg), 3)[1])
        assert shard._merge_topk(parts, 3)[0].tolist() == np.take_along_axis(ids, args,
                                                                              -1).tolist()


def test_merge_fills_invalid_slots_as_voge_tpu():
    """Invalid slots (idx < 0) sort last whatever their length and come out
    as idx -1, len 1e10, act 1e10, dsd 0 (``shard.py:78-84``)."""
    a = _lists([-1, 4, -1], [0.5, 3.0, 0.1])
    b = _lists([-1, -1, -1], [0.2, 1e10, 1e10])
    idx, length, act, dsd = shard._merge_topk((a, b), 3)
    assert idx.tolist() == [[4, -1, -1]]
    assert length.tolist() == [[3.0, 1e10, 1e10]] and act.tolist() == [[30.0, 1e10, 1e10]]
    assert dsd.tolist() == [[300.0, 0.0, 0.0]]
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("ring", [False, True])
def test_padded_gaussians_are_never_selected(ring):
    """Gaussians padded at 100.0 appear in no list and get a zero gradient;
    the ids are the single-device ``b * N + n``."""
    verts, sigmas, cams, n = _scene_and_cams(B=2, N=100)
    N = verts.shape[0]
    assert N > n
    kw = dict(image_size=(32, 32), max_assign=6, max_point_per_bin=-1, ring=ring)
    v, s = _t(verts, True), _t(sigmas, True)
    f = render_pipeline_sharded(v, s, *map(_t, cams),
                                mesh=make_mesh(("data", "model"), (2, 4), devices=CPU8), **kw)
    idx = f.vert_index
    assert ((idx < 0) | (idx % N < n)).all()
    assert ((idx[1] < 0) | (idx[1] >= N)).all() and (idx[0] < N).all()
    gv, gs = torch.autograd.grad((f.vert_weight ** 2).sum(), (v, s))
    assert (gv[n:] == 0).all() and (gs[n:] == 0).all() and gv[:n].abs().sum() > 0


def test_data_parallel_batchifier_runs():
    """Twin of ``tests/test_parallel.py::test_data_parallel_batchifier_runs``:
    24 rows over 8 logical shards, against ``voge_tpu``'s."""
    dp = DataParallelBatchifier(8, batch_args="x", target_dims=0,
                                mesh=make_mesh(("dp",), devices=CPU8))
    out = dp(lambda x: x * 2.0)(x=torch.arange(24.0).reshape(24, 1))
    want = JDataParallelBatchifier(8, batch_args="x", target_dims=0)(jax.jit(lambda x: x * 2.0))(
        x=jnp.arange(24.0).reshape(24, 1))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_data_parallel_batchifier_pads_by_the_edge_and_crops():
    """A chunk whose length is no multiple of the device count: padded with
    copies of its last row, one equal slice a shard, outputs cropped back."""
    seen = []

    def fn(x, y):
        seen.append((x.shape[0], x[:, 0].tolist()))
        return x + y, (x * y).sum(-1)

    dp = DataParallelBatchifier(10, batch_args=("x", "y"), target_dims=0,
                                mesh=make_mesh(("dp",), (4,), devices=["cpu"] * 4))
    x = torch.arange(13.0)[:, None].repeat(1, 2)
    y = torch.ones(13, 2)
    s, p = dp(fn)(x=x, y=y)
    torch.testing.assert_close(s, x + y)
    torch.testing.assert_close(p, (x * y).sum(-1))
    # batchify's chunks of 10 (the second padded to 10 with row 12), each
    # padded to 12 and cut into four slices of 3
    assert [n for n, _ in seen] == [3] * 8
    assert seen[3][1] == [9.0, 9.0, 9.0] and seen[7][1] == [12.0, 12.0, 12.0]


def test_make_mesh_takes_the_cards_and_never_the_cpu(monkeypatch):
    """Without ``devices`` the mesh is every visible card; with none it
    raises and never falls back to the CPU (the device rule of
    ``tests/test_torch_geometry.py::test_default_device_is_the_card``)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelBatchifier(8, "x")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh(("data", "model"), (2, 2))
    assert mesh.shape == {"data": 2, "model": 2} and mesh.devices.size == 4
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert make_mesh().devices.shape == (4,)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(("data",), (3,), devices=CPU8)
    m = make_mesh(("model", "data"), (2, 4), devices=[f"cuda:{i}" for i in range(8)])
    assert [str(d) for d in shard._grid(m, "data", "model")[1]] == ["cuda:1", "cuda:5"]
    assert shard._grid(m, "data", None).shape == (4, 1)


def test_each_shard_runs_on_its_own_device():
    """A shard on a card runs under ``torch.cuda.device`` of that card, and
    every kernel wrapper launches on the stream of its tensors' device (the
    CUDA runtime launches on the current card: a static check, since one
    card cannot show the fault)."""
    scope = shard._scope(torch.device("cuda", 3))
    assert isinstance(scope, torch.cuda.device) and scope.idx == 3
    assert not isinstance(shard._scope(torch.device("cpu")), torch.cuda.device)
    ops = Path(vt.__file__).resolve().parent / "ops"
    calls = 0
    for path in sorted(ops.glob("cuda_*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if not isinstance(fn, ast.FunctionDef):
                continue
            from_device = {t.id for node in ast.walk(fn) if isinstance(node, ast.Assign)
                           and isinstance(node.value, ast.Attribute)
                           and node.value.attr == "device"
                           for t in node.targets if isinstance(t, ast.Name)}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id == "stream"):
                    (arg,) = node.args
                    ok = ((isinstance(arg, ast.Attribute) and arg.attr == "device")
                          or (isinstance(arg, ast.Name) and arg.id in from_device))
                    assert ok, (path.name, fn.name, ast.unparse(node))
                    calls += 1
    assert calls >= 16
