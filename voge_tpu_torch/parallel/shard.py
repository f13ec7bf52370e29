"""Sharding over a mesh of devices (counterpart of
``voge_tpu/parallel/shard.py``), driven from one process.

``voge_tpu`` shards with one ``shard_map`` over a ``jax.sharding.Mesh``: a
single controller, the collectives between its shards.  The port keeps that
structure with a :class:`Mesh` over a list of ``torch.device``s and a Python
loop over its shards: each shard's work runs on its own device (under
``torch.cuda.device`` for a card), and a collective is a move between
devices: ``all_gather`` is a ``torch.cat`` of the shards' tensors brought to
one device, ``ppermute`` a ``.to`` of each block to the next shard's device,
``psum`` a sum in shard order.  Autograd runs back through the moves, so
every route is differentiable end to end.  A device may appear in a mesh
more than once (the analog of JAX's virtual host devices): the CPU tests run
eight logical shards on ``cpu``, a card can hold every shard of a mesh, and
on a box with several cards the same code puts each shard on its own card.

- **camera axis** (``data``): each data shard renders its slice of the
  camera batch;
- **Gaussian axis** (``model``, the context-parallel analog): each model
  shard selects against its N / m Gaussians, and the per-pixel K-lists are
  gathered and reduced to the global K nearest (exact: each shard keeps its
  own K nearest);
- **ring** (``ring=True``): the model axis shards the pixel rows; Gaussian
  blocks rotate around the axis, each shard folding one visiting block a step
  into its running top-K, so per-pixel state stays K wide;
- **replicated scene** (``model_axis=None``): the whole
  :func:`~voge_tpu_torch.renderer.render_pipeline` per data shard;
  :func:`interpolate_attr_sharded` / :func:`sample_features_sharded` re-enter
  the shards.

Selection runs the port's kernels on each shard (K1 + K2, or K2's global
entry without a coarse stage); compositing runs on the merged lists with the
plain erf weights (``aggregation``), since weights do not merge across
shards.  The backward is K3 with the cotangents of len, act and dsd and no
weight cotangent.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from voge_tpu_torch._device import normalize_device
from voge_tpu_torch.aggregation import aggregation, expend_sigma
from voge_tpu_torch.ops.fine import ray_tracing
from voge_tpu_torch.parallel.batchify import batchify
from voge_tpu_torch.renderer import (
    Fragments, _render_inputs, interpolate_attr, render_pipeline,
)
from voge_tpu_torch.sampler import sample_features

# the fill of an empty slot (``voge_tpu.ops.fine``'s sentinels)
_SENTINEL_LEN = 1e10
_SENTINEL_ACT = 1e10


class Mesh:
    """Devices laid out on named axes (``jax.sharding.Mesh``'s reading):
    ``devices`` is a numpy object array of ``torch.device``s, ``shape`` maps
    each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (default: every visible card; with
    none it raises, never falling back to the CPU).  A device may repeat:
    ``make_mesh(("data", "model"), (2, 4), devices=["cpu"] * 8)`` is eight
    logical shards on the CPU.  With ``shape=None`` all devices go to the
    first axis."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(for example ['cpu'] * 8) for logical shards elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [normalize_device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def _grid(mesh: Mesh, *axes: Optional[str]) -> np.ndarray:
    """The mesh's devices as an array over ``axes`` (None: an axis of size
    one), the first device along every other axis."""
    names = list(mesh.axis_names)
    for a in axes:
        if a is not None and a not in names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {tuple(names)}")
    order = [names.index(a) for a in axes if a is not None]
    rest = [i for i in range(len(names)) if i not in order]
    arr = np.transpose(mesh.devices, order + rest)
    arr = arr[(slice(None),) * len(order) + (0,) * len(rest)]
    return arr.reshape(tuple(mesh.shape[a] if a is not None else 1 for a in axes))


def _scope(device: torch.device):
    """Make ``device`` current while a shard's work runs: the kernels launch
    on the current card, on the stream of their tensors' device."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _merge_topk(parts, K: int):
    """The K nearest of per-pixel K-lists: ``parts`` are (idx, len, act, dsd)
    tuples (..., K_i), concatenated in order.  A stable ascending sort on the
    length (invalid slots at the sentinel) keeps the lower position on ties,
    as ``lax.top_k`` does; unfilled slots take idx -1, len / act 1e10,
    dsd 0 (``shard.py:66-84``)."""
    g_idx, g_len, g_act, g_dsd = (torch.cat(x, dim=-1) for x in zip(*parts))
    valid = g_idx >= 0
    order = torch.sort(torch.where(valid, g_len, _SENTINEL_LEN), dim=-1,
                       stable=True).indices[..., :K]
    ok = valid.gather(-1, order)
    take = lambda x: x.gather(-1, order)
    return (torch.where(ok, take(g_idx), -1), torch.where(ok, take(g_len), _SENTINEL_LEN),
            torch.where(ok, take(g_act), _SENTINEL_ACT), torch.where(ok, take(g_dsd), 0.0))


def _select_block(verts_l, sigmas_l, cams_l, src: int, n_total: int, size, opts):
    """Selection of one Gaussian block (N_l of them, shard ``src`` of the
    model axis) for the local cameras, on the device of ``verts_l``: K-lists
    (idx, len, act, dsd) with the ids mapped from local ``b * N_l + p`` to
    ``b * N + src * N_l + p``, and the coarse stage's overflow."""
    cams, points, isig, rays, origins, _ = _render_inputs(
        verts_l, sigmas_l, *cams_l, size, opts["inverse_sigma"], None, None, torch.float32)
    (idx, length, act, dsd, _w, _img), ovf = ray_tracing(
        cams, points, isig, rays, size, thr=opts["thr_activation"],
        n_assign=opts["max_assign"], bin_size=opts["bin_size"],
        max_points_per_bin=opts["max_point_per_bin"], agg_ow=opts["absorptivity"],
        origins=origins)
    n_l = verts_l.shape[0]
    g_idx = (idx // n_l) * n_total + src * n_l + idx % n_l
    return (torch.where(idx >= 0, g_idx, -1), length, act, dsd), ovf


def _composite(sel, offset: int, absorptivity: float):
    """Shift the ids by the data shard's ``offset`` and weight the merged
    lists: (weight, idx, valid_num, len)."""
    idx, length, act, dsd = sel
    idx = torch.where(idx >= 0, idx + offset, -1)
    return aggregation(idx, act, length, dsd, occupation_weight=absorptivity)


def render_pipeline_sharded(
    verts: torch.Tensor, sigmas: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
    focal: torch.Tensor, principal: torch.Tensor, *, mesh: Mesh,
    image_size: Tuple[int, int], max_assign: int = 20, thr_activation: float = 0.01,
    absorptivity: float = 1.0, inverse_sigma: bool = False,
    bin_size: Optional[int] = None, max_point_per_bin: Optional[int] = None,
    data_axis: str = "data", model_axis: Optional[str] = "model", ring: bool = False,
) -> Fragments:
    """Render with the cameras sharded over ``data_axis`` and the Gaussians
    over ``model_axis`` (None: the scene replicated, pure camera data
    parallelism).  ``ring=True`` shards the pixel rows over the model axis
    and rotates the Gaussian blocks instead of gathering every shard's
    K-lists.  Differentiable in ``verts``, ``sigmas`` and the cameras.

    :param verts: (N, 3) world means of one unbatched scene; N divisible by
        the model axis (pad with far-away Gaussians)
    :param R, T, focal, principal: (B, ...) cameras; B divisible by the data
        axis
    :return: :class:`Fragments` on the mesh's first device, ``vert_index``
        holding the single-device renderer's global ``b * N + n``;
        ``overflow_points`` sums every shard's
    """
    sigmas = expend_sigma(sigmas)
    B, N = R.shape[0], verts.shape[0]
    d_size = mesh.shape[data_axis]
    m_size = mesh.shape[model_axis] if model_axis is not None else 1
    if B % d_size:
        raise ValueError(f"camera batch {B} not divisible by {d_size}")
    if N % m_size:
        raise ValueError(f"num Gaussians {N} not divisible by {m_size}")
    opts = dict(image_size=tuple(int(s) for s in image_size), max_assign=int(max_assign),
                thr_activation=thr_activation, absorptivity=absorptivity,
                inverse_sigma=inverse_sigma, bin_size=bin_size,
                max_point_per_bin=max_point_per_bin)
    if model_axis is None:
        return _replicated_dp_render(verts, sigmas, R, T, focal, principal, mesh=mesh,
                                     data_axis=data_axis, **opts)
    H, W = opts["image_size"]
    if ring and H % m_size:
        raise ValueError(f"image height {H} not divisible by model axis size {m_size} "
                         "(required for ring=True)")
    grid = _grid(mesh, data_axis, model_axis)
    out_dev = mesh.devices.flat[0]
    B_l, N_l, K = B // d_size, N // m_size, opts["max_assign"]
    blocks = [(verts[i * N_l:(i + 1) * N_l], sigmas[i * N_l:(i + 1) * N_l])
              for i in range(m_size)]
    frags, ovfs = [], []
    for d in range(d_size):
        cams_d = [x[d * B_l:(d + 1) * B_l] for x in (R, T, focal, principal)]
        devs = list(grid[d])
        cams = [[x.to(dev) for x in cams_d] for dev in devs]
        if ring:
            # shard ``my`` renders rows [my H_l, (my + 1) H_l): the principal
            # point's row coordinate shifted by my H_l, a sub-image (H_l, W)
            H_l = H // m_size
            for my, c in enumerate(cams):
                c[3] = c[3] - torch.tensor([0.0, my * H_l], dtype=c[3].dtype, device=c[3].device)
            blk = [(v.to(dev), s.to(dev)) for (v, s), dev in zip(blocks, devs)]
            run = [None] * m_size
            for s in range(m_size):
                for my, dev in enumerate(devs):
                    with _scope(dev):
                        sel, ovf = _select_block(*blk[my], cams[my], (my - s) % m_size, N,
                                                 (H_l, W), opts)
                        run[my] = sel if run[my] is None else _merge_topk((run[my], sel), K)
                    ovfs.append(ovf)
                if s < m_size - 1:      # each block moves on to the next shard
                    blk = [tuple(x.to(devs[my]) for x in blk[(my - 1) % m_size])
                           for my in range(m_size)]
            rows = []
            for my, dev in enumerate(devs):
                with _scope(dev):
                    rows.append([x.to(out_dev) for x in _composite(run[my], d * B_l * N,
                                                                   absorptivity)])
            frags.append([torch.cat(x, dim=1) for x in zip(*rows)])
        else:
            parts = []
            for m, dev in enumerate(devs):
                with _scope(dev):
                    v, s = (x.to(dev) for x in blocks[m])
                    sel, ovf = _select_block(v, s, cams[m], m, N, (H, W), opts)
                parts.append([x.to(devs[0]) for x in sel])
                ovfs.append(ovf)
            with _scope(devs[0]):
                merged = _merge_topk(parts, K)
                frags.append([x.to(out_dev) for x in _composite(merged, d * B_l * N,
                                                                absorptivity)])
    weight, idx, valid_num, length = (torch.cat(x) for x in zip(*frags))
    return Fragments(weight, idx, valid_num, length,
                     overflow_points=_sum_in_order(ovfs, out_dev))


def _sum_in_order(values, device) -> torch.Tensor:
    """A cross-shard sum (``psum``) in shard order, on ``device``."""
    return torch.stack([v.to(device) for v in values]).sum().to(torch.int32)


class _ReplicatedFragments(Fragments):
    """The fragments of a replicated-scene sharded render: ``scene_size``
    (the scene's Gaussian count N) lets :func:`interpolate_attr_sharded` /
    :func:`sample_features_sharded` re-enter its data shards on local ids."""

    def __init__(self, *args, scene_size: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.scene_size = scene_size


def _replicated_dp_render(verts, sigmas, R, T, focal, principal, *, mesh, data_axis,
                          **rp_kwargs) -> _ReplicatedFragments:
    """Camera data parallelism with the scene replicated: the whole
    :func:`render_pipeline` per data shard on its device, the shards'
    fragments concatenated on the mesh's first device, ``vert_index`` offset
    to the global camera index; the sharded helpers re-enter the shards
    (``shard.py:286-330``)."""
    devs = list(_grid(mesh, data_axis).reshape(-1))
    out_dev = mesh.devices.flat[0]
    B, N = R.shape[0], verts.shape[0]
    B_l = B // len(devs)
    parts, ovfs = [], []
    for d, dev in enumerate(devs):
        sl = slice(d * B_l, (d + 1) * B_l)
        with _scope(dev):
            frag = render_pipeline(verts.to(dev), sigmas.to(dev),
                                   *(x[sl].to(dev) for x in (R, T, focal, principal)),
                                   **rp_kwargs)
        vi = torch.where(frag.vert_index >= 0, frag.vert_index + d * B_l * N, -1)
        parts.append([x.to(out_dev) for x in (frag.vert_weight, vi, frag.valid_num,
                                              frag.vert_hit_length)])
        ovfs.append(frag.overflow_points)
    weight, idx, valid_num, length = (torch.cat(x) for x in zip(*parts))
    return _ReplicatedFragments(weight, idx, valid_num, length,
                                overflow_points=_sum_in_order(ovfs, out_dev), scene_size=N)


def _local_fragments(frag: _ReplicatedFragments, d: int, B_l: int, device) -> Fragments:
    """Data shard ``d``'s fragments on ``device``, with the shard-local ids
    ``b * N + n`` of its own render restored."""
    N = frag.scene_size
    sl = slice(d * B_l, (d + 1) * B_l)
    vi = frag.vert_index[sl]
    vi = torch.where(vi >= 0, vi % (B_l * N), -1)
    return Fragments(frag.vert_weight[sl].to(device), vi.to(device),
                     frag.valid_num[sl].to(device), frag.vert_hit_length[sl].to(device))


def interpolate_attr_sharded(frag: Fragments, vert_attr: torch.Tensor, mesh: Mesh,
                             data_axis: str = "data") -> torch.Tensor:
    """Attribute compositing on the fragments of a replicated-scene sharded
    render: K3f per data shard on its own device, on local ids, the images
    concatenated on the mesh's first device.  Other fragments take
    :func:`interpolate_attr` as they are.

    :param vert_attr: (N, C) scene attributes or (B * N, C) per camera
    """
    if not isinstance(frag, _ReplicatedFragments):
        return interpolate_attr(frag, vert_attr)
    devs = list(_grid(mesh, data_axis).reshape(-1))
    N, B = frag.scene_size, frag.vert_weight.shape[0]
    B_l = B // len(devs)
    per_camera = vert_attr.shape[0] != N
    out = []
    for d, dev in enumerate(devs):
        attr = vert_attr[d * B_l * N:(d + 1) * B_l * N] if per_camera else vert_attr
        with _scope(dev):
            img = interpolate_attr(_local_fragments(frag, d, B_l, dev), attr.to(dev))
        out.append(img.to(mesh.devices.flat[0]))
    return torch.cat(out)


def sample_features_sharded(frag: Fragments, image: torch.Tensor, n_vert: int, mesh: Mesh,
                            data_axis: str = "data"):
    """Inverse rendering on the fragments of a replicated-scene sharded
    render: each data shard scatters its own cameras' pixels onto its
    disjoint rows ``(b, n)`` on its device (``attr_scatter``; ``attr_dw`` +
    K3f in the backward), so the result is the concatenation.  Needs
    ``n_vert == B * N``.  Other fragments take :func:`sample_features`.

    :return: (vert_feature (n_vert, C), vert_sum_weight (n_vert,)) on the
        mesh's first device
    """
    if not isinstance(frag, _ReplicatedFragments):
        return sample_features(frag, image, n_vert=n_vert)
    devs = list(_grid(mesh, data_axis).reshape(-1))
    N, B = frag.scene_size, frag.vert_weight.shape[0]
    if n_vert != B * N:
        raise ValueError(f"sample_features_sharded needs n_vert == B * N ({B} * {N}); "
                         f"got {n_vert}")
    B_l = B // len(devs)
    out_dev = mesh.devices.flat[0]
    feats, sums = [], []
    for d, dev in enumerate(devs):
        with _scope(dev):
            f, s = sample_features(_local_fragments(frag, d, B_l, dev),
                                   image[d * B_l:(d + 1) * B_l].to(dev), n_vert=B_l * N)
        feats.append(f.to(out_dev))
        sums.append(s.to(out_dev))
    return torch.cat(feats), torch.cat(sums)


def _gather(parts, device):
    """Concatenate the shards' outputs (tensors, or tuples / lists of them)
    along the first axis on ``device``."""
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([p[i] for p in parts], device) for i in range(len(first)))
    return torch.cat([p.to(device) for p in parts])


class DataParallelBatchifier:
    """The reference's multi-GPU batchifier (``Utils.py:179-333``: shard the
    batch over the devices, run the function on each, gather the outputs to
    one device), driven from one thread over a 1-D :class:`Mesh`.  Each
    chunk of :func:`batchify` has its leading axis padded to a multiple of
    the mesh's device count (edge mode: the repeated rows stay valid
    inputs), split into one slice a device, ``func`` runs on each slice with
    its inputs moved there, and the outputs are concatenated on ``device``
    (default: the mesh's first device) and cropped back.

    :param mesh: default ``make_mesh(("dp",))``, every visible card
    """

    def __init__(self, batch_size: int, batch_args, target_dims=None, remain_dims=None,
                 device=None, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh(("dp",))
        self.device = normalize_device(device) if device is not None else self.mesh.devices.flat[0]
        self.batch_size = batch_size
        self.batch_args = (batch_args,) if isinstance(batch_args, str) else tuple(batch_args)
        self.target_dims = target_dims
        self.remain_dims = remain_dims

    def __call__(self, func):
        devs, batch_args, out_dev = list(self.mesh.devices.flat), self.batch_args, self.device

        def sharded_fn(*args, **kwargs):
            n_dev = len(devs)
            orig_len = kwargs[batch_args[0]].shape[0]
            per = -(-orig_len // n_dev)
            for k in batch_args:
                x = kwargs[k]
                if x.shape[0] % n_dev:
                    edge = x[-1:].expand((per * n_dev - x.shape[0],) + x.shape[1:])
                    x = torch.cat([x, edge])
                kwargs[k] = x
            outs = []
            for d, dev in enumerate(devs):
                kw = dict(kwargs)
                for k in batch_args:
                    kw[k] = kwargs[k][d * per:(d + 1) * per].to(dev)
                with _scope(dev):
                    outs.append(func(*args, **kw))
            out = _gather(outs, out_dev)
            if per * n_dev != orig_len:
                crop = lambda y: y[:orig_len] if isinstance(y, torch.Tensor) else y
                out = type(out)(crop(y) for y in out) if isinstance(out, (tuple, list)) \
                    else crop(out)
            return out

        return batchify(sharded_fn, self.batch_size, self.batch_args,
                        self.target_dims, self.remain_dims)
