"""Renderer API (counterpart of ``voge_tpu/renderer.py`` and the reference
``VoGE/Renderer.py``): ``Fragments``, ``GaussianRenderSettings``,
``render_pipeline``, ``GaussianRenderer`` and the compositing helpers.

The forward runs the coarse emission (K1), the fused select (K2) and, through
``interpolate_attr``, the attribute merge (K3f).  A ``.backward()`` through a
render runs the fine backward (K3, with the weight fold and the fused
attribute VJP) and the attribute-merge backward (K4b), and gathers the
gradients back to the Gaussians without float atomics.  With
``max_point_per_bin=-1`` (no coarse stage, the ShapeFitting setting) there
is no K1: K2's and K3's global entries take every Gaussian of an image as a
candidate of each of its pixels.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from voge_tpu_torch import trace
from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.cameras import PerspectiveCameras
from voge_tpu_torch.ops.cuda_attr import AttrMerge
from voge_tpu_torch.ops.fine import ray_tracing
from voge_tpu_torch.rays import camera_rays
from voge_tpu_torch.utils import inv3x3


class Fragments:
    """Per-pixel render result.

    - ``vert_weight`` (B, H, W, K) float32: occlusion-aware contribution
    - ``vert_index``  (B, H, W, K) int32: flattened ``b * N + n`` index, -1 empty
    - ``valid_num``   (B, H, W) int64: number of valid slots
    - ``vert_hit_length`` (B, H, W, K) float32: ray parameter of the density peak
    - ``overflow_points``: candidate memberships the coarse stage dropped
      (0 means exact), or None when unknown
    - ``attr_img`` (B, H, W, d): the attribute image, when the render was
      given ``attrs=``
    """

    def __init__(self, vert_weight, vert_index, valid_num, vert_hit_length,
                 overflow_points=None, attr_img=None):
        self.vert_weight = vert_weight
        self.vert_index = vert_index
        self.valid_num = valid_num
        self.vert_hit_length = vert_hit_length
        self.overflow_points = overflow_points
        self.attr_img = attr_img

    def __getitem__(self, item):
        if self.valid_num.ndim != 3:
            raise IndexError("Index access is only available when batched.")
        return Fragments(self.vert_weight[item], self.vert_index[item],
                         self.valid_num[item], self.vert_hit_length[item])

    def __len__(self):
        return self.valid_num.shape[0]

    @property
    def shape(self):
        return (self.vert_weight.shape, self.vert_index.shape,
                self.valid_num.shape, self.vert_hit_length.shape)

    def squeeze(self):
        if self.valid_num.shape[0] != 1:
            raise ValueError("squeeze needs a batch of one")
        return self[0]

    def unsqueeze(self):
        if self.valid_num.ndim != 2:
            raise ValueError("unsqueeze needs unbatched fragments")
        return Fragments(self.vert_weight[None], self.vert_index[None],
                         self.valid_num[None], self.vert_hit_length[None])

    def to_dict(self):
        return dict(vert_weight=self.vert_weight, vert_index=self.vert_index,
                    valid_num=self.valid_num,
                    vert_hit_length=self.vert_hit_length)

    def copy(self):
        return Fragments(**self.to_dict())


class GaussianRenderSettings:
    """Render configuration (reference ``Renderer.py:53-84``).  Unknown
    keyword arguments are accepted and ignored, as reference demo scripts
    pass some (e.g. ``batch_size=-1``)."""

    __slots__ = ["image_size", "max_assign", "thr_activation", "absorptivity",
                 "inverse_sigma", "principal", "max_point_per_bin", "bin_size"]

    def __init__(self, image_size: Union[int, Tuple[int, int]] = 256,
                 max_assign: int = 20, thr_activation: float = 0.01,
                 absorptivity: float = 1, inverse_sigma: bool = False,
                 principal=None, max_point_per_bin: Optional[int] = None,
                 bin_size: Optional[int] = None, **kwargs):
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self.image_size = tuple(int(v) for v in image_size)
        self.max_assign = int(max_assign)
        self.thr_activation = float(thr_activation)
        self.absorptivity = float(absorptivity)
        self.inverse_sigma = bool(inverse_sigma)
        self.principal = principal
        self.max_point_per_bin = max_point_per_bin
        self.bin_size = bin_size

    def __getitem__(self, item):
        return getattr(self, item)


class CameraCtx:
    """Camera-static tensors for :func:`render_pipeline`: ray directions
    (B, H, W, 3) and origins (B, 3), built without autograd.  It must match
    the cameras of the call: gradients for the cameras flow only when the
    render builds its rays from them (no context)."""

    def __init__(self, rays: torch.Tensor, origins: torch.Tensor):
        self.rays = rays
        self.origins = origins


def precompute_camera_ctx(R, T, focal, principal, image_size,
                          n_gauss: Optional[int] = None, max_assign: int = 20,
                          bin_size: Optional[int] = None,
                          max_point_per_bin: Optional[int] = None,
                          device=None) -> CameraCtx:
    """Build a :class:`CameraCtx` once for a loop over fixed cameras, with
    ``voge_tpu.renderer.precompute_camera_ctx``'s signature.  ``n_gauss``,
    ``max_assign``, ``bin_size`` and ``max_point_per_bin`` fix the bin
    geometry of ``voge_tpu``'s cached ray-feature planes; the port's select
    reads the rays directly and keeps no such planes, so they change
    nothing here.  ``device`` is where the tensors are placed (None: the
    device of a tensor among the cameras, else the card,
    ``_device.resolve_device``)."""
    with torch.no_grad():
        dev = resolve_device(device, R, T, focal, principal)
        R, T, focal, principal = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                                  for x in (R, T, focal, principal))
        return CameraCtx(*camera_rays(R, T, focal, principal, image_size))


def render_pipeline(
    verts: torch.Tensor, sigmas: torch.Tensor, R: torch.Tensor,
    T: torch.Tensor, focal: torch.Tensor, principal: torch.Tensor, *,
    image_size: Tuple[int, int], max_assign: int = 20,
    thr_activation: float = 0.01, absorptivity: float = 1.0,
    inverse_sigma: bool = False, bin_size: Optional[int] = None,
    max_point_per_bin: Optional[int] = None,
    cam_ctx: Optional[CameraCtx] = None,
    camera_grad: bool = True,
    attrs: Optional[torch.Tensor] = None,
) -> Fragments:
    """Render (reference ``Renderer.py:102-150``): rays, verts centred on the
    camera, sigmas scaled (or inverted), coarse + fine ray tracing with the
    erf compositing fused in.  Differentiable in ``verts``, ``sigmas``,
    ``attrs`` and the cameras.

    :param verts: (B, N, 3) or (N, 3); :param sigmas: (N,), (N, 3) or (N, 3, 3)
    :param R, T, focal, principal: (B, 3, 3), (B, 3), (B, 2), (B, 2)
    :param cam_ctx: rays and origins from :func:`precompute_camera_ctx` for a
        loop over fixed cameras (constants: no camera gradient through them)
    :param camera_grad: False declares the camera pose not differentiated:
        the backward skips the ray gradient and its per-ray reduction
    :param max_point_per_bin: None for the default coarse stage, -1 for none
        (every Gaussian a candidate of every pixel, nothing truncated)
    :param attrs: optional (N, d) or (B, N, d) attributes; the fragments then
        carry ``attr_img = interpolate_attr(frag, attrs)``, computed in the
        select kernel (by the attribute merge without a coarse stage)

    The render computes in float32 (inputs of any floating dtype, bfloat16
    too, are promoted to it).  ``max_assign`` above 128 (the select kernel's
    ``MAX_K``) takes the dense route, as ``voge_tpu`` takes its XLA select
    there.
    """
    with trace.span("voge.render"):
        cams, verts, isigma, rays, origins, attrs_b = _render_inputs(
            verts, sigmas, R, T, focal, principal, image_size, inverse_sigma, cam_ctx, attrs,
            torch.float32)
        # verts are centred on the cameras inside, so that a scene that needs no
        # gradient (pose refinement) takes the backward's per-ray route
        (idx, length, _act, _dsd, weight, img), overflow = ray_tracing(
            cams, verts, isigma, rays, image_size,
            thr=thr_activation, n_assign=max_assign, bin_size=bin_size,
            max_points_per_bin=max_point_per_bin, agg_ow=float(absorptivity),
            attrs=attrs_b, camera_grad=camera_grad, origins=origins,
        )
        return Fragments(weight, idx, (idx >= 0).sum(-1), length,
                         overflow_points=overflow, attr_img=img)


def _render_inputs(verts, sigmas, R, T, focal, principal, image_size, inverse_sigma,
                   cam_ctx, attrs, dt):
    """What a render traces, in dtype ``dt``: the cameras, verts (B, N, 3),
    precisions (B, N, 3, 3), rays (B, H, W, 3), ray origins (B, 3) and
    attributes (B, N, d) or None."""
    dev = verts.device
    verts = verts.to(dt)
    sigmas = expend_sigma(torch.as_tensor(sigmas, device=dev).to(dt))
    if verts.ndim == 2:
        verts = verts[None]
    R, T, focal, principal = (torch.as_tensor(x, device=dev).to(dt)
                              for x in (R, T, focal, principal))
    B = R.shape[0]
    if verts.shape[0] == 1 and B > 1:
        verts = verts.expand((B,) + verts.shape[1:])
    if cam_ctx is not None:
        rays, origins = cam_ctx.rays.to(dt), cam_ctx.origins.to(dt)
    else:
        rays, origins = camera_rays(R, T, focal, principal, image_size)
    if sigmas.ndim == 3:
        sigmas = sigmas[None].expand((verts.shape[0],) + sigmas.shape)
    isigma = 2.0 * (inv3x3(sigmas) if inverse_sigma else sigmas)
    attrs_b = None
    if attrs is not None:
        attrs_b = torch.as_tensor(attrs, device=dev).to(dt)
        if attrs_b.ndim == 2:
            attrs_b = attrs_b[None]
        attrs_b = attrs_b.expand((verts.shape[0],) + attrs_b.shape[1:])
    return (R, T, focal, principal), verts, isigma, rays, origins, attrs_b


class GaussianRenderer(nn.Module):
    """Holds a camera batch and settings (reference ``Renderer.py:87-150``);
    the call kwargs ``R``, ``T``, ``focal``, ``principal`` update the
    cameras.  Renders on the device of the scene's ``verts``.  The camera
    context is kept between calls while the cameras' values and the settings
    stay the same; cameras that need a gradient bypass it, so pose gradients
    flow through the rays."""

    to_set_args = ["R", "T", "focal", "principal"]

    def __init__(self, cameras: PerspectiveCameras, render_settings):
        super().__init__()
        if isinstance(render_settings, dict):
            render_settings = GaussianRenderSettings(**render_settings)
        self.cameras = cameras
        self.render_settings = render_settings

    @property
    def device(self) -> torch.device:
        """The cameras' device (``voge_tpu``'s renderer has the property; an
        ``nn.Module`` has none)."""
        return self.cameras.device

    def forward(self, gmeshes, **kwargs) -> Fragments:
        if self.cameras.in_ndc():
            raise ValueError("Got NDC camera. Cameras.in_ndc must be set to false.")
        for name in self.to_set_args:
            if name in kwargs:
                # any array (numpy, list, CPU tensor, float64), as voge_tpu
                # takes: one device and one dtype with the cameras
                setattr(self.cameras, name, torch.as_tensor(
                    kwargs[name], dtype=self.cameras.dtype, device=self.cameras.device))
        verts, sigmas, _radians = gmeshes()
        s = self.render_settings
        B = max(self.cameras.R.shape[0], 1 if verts.ndim == 2 else verts.shape[0])
        R, T, focal, principal = self.cameras.batched_params(B)
        return render_pipeline(
            verts, sigmas, R, T, focal, principal,
            image_size=tuple(s.image_size), max_assign=s.max_assign,
            thr_activation=s.thr_activation, absorptivity=s.absorptivity,
            inverse_sigma=s.inverse_sigma, bin_size=s.bin_size,
            max_point_per_bin=s.max_point_per_bin,
            cam_ctx=self._cached_camera_ctx(R, T, focal, principal,
                                            tuple(s.image_size)),
        )

    def _cached_camera_ctx(self, R, T, focal, principal, image_size):
        """The camera context, kept while the cameras' values and the image
        size stay the same (``voge_tpu``'s ``_cached_camera_ctx``); None when
        a camera tensor requires grad."""
        cams = (R, T, focal, principal)
        if any(x.requires_grad for x in cams):
            return None
        key = (tuple(x.detach().cpu().numpy().tobytes() for x in cams),
               R.device, image_size)
        trace.count("host_reads", len(cams))
        if getattr(self, "_cam_ctx_key", None) != key:
            self._cam_ctx_val = precompute_camera_ctx(R, T, focal, principal,
                                                      image_size, device=R.device)
            self._cam_ctx_key = key
        return self._cam_ctx_val

def interpolate_attr(fragments: Fragments, vert_attr: torch.Tensor) -> torch.Tensor:
    """Composite per-kernel attributes (N, d) or (B * N, d) into an
    attribute map (B, H, W, d) with the attribute-merge kernel (K3f), in
    float32 (attributes of any floating dtype are promoted to it).
    ``vert_index`` holds flattened ``b * N + n`` indices, so with a camera
    batch above one, N-row attributes are tiled over the batch."""
    with trace.span("voge.attr"):
        idx = fragments.vert_index
        attrs = torch.as_tensor(vert_attr, device=idx.device).to(torch.float32)
        B = idx.shape[0]
        if fragments.valid_num.ndim == 3 and B > 1 and attrs.ndim == 2:
            attrs = attrs.repeat(B, 1)
        return AttrMerge.apply(fragments.vert_weight.contiguous(),
                               attrs.contiguous(), idx.contiguous())


def get_overflow_points(fragments: Fragments) -> int:
    """Candidate memberships the coarse stage dropped (0 = exact; 0 too when
    the fragments do not carry the count)."""
    ovf = fragments.overflow_points
    return 0 if ovf is None else int(ovf)


def get_silhouette(fragments: Fragments) -> torch.Tensor:
    """Per-pixel silhouette ``min(sum_k w_k, 1)`` (at a tie the gradient
    splits evenly, as ``jnp.minimum``'s does)."""
    w = fragments.vert_weight.sum(-1)
    return torch.minimum(w, torch.ones_like(w))


def to_colored_background(fragments: Fragments, colors: torch.Tensor,
                          background_color=(1.0, 1.0, 1.0), thr: float = -1):
    masks = get_silhouette(fragments)[..., None]
    if thr > 0:
        masks = (masks > thr).to(masks.dtype)
    rgb = interpolate_attr(fragments, colors)
    bg = torch.as_tensor(background_color, dtype=rgb.dtype, device=rgb.device)
    out = rgb + (1 - masks) * bg
    return torch.minimum(out, torch.ones_like(out))


def to_white_background(fragments: Fragments, colors: torch.Tensor,
                        thr: float = -1):
    return to_colored_background(fragments, colors, (1.0, 1.0, 1.0), thr)
