"""The plain reference render: VoGE's closed-form volume ray tracing of 3-D
Gaussians (Wang et al., arXiv 2205.15401), written from its definition in
plain PyTorch.  It imports nothing of the program and takes nothing the
program made.

For a pixel's unit ray r from the camera centre C and a Gaussian of mean mu
and precision L (``2 * sigmas`` of the scene file's inverse sigmas, as VoGE
scales them), with m = mu - C:

    length = m^T L r / r^T L r      (the ray parameter of the density peak)
    act    = d^T L d, d = m - length r
    dsd    = r^T L r

A pair passes when ``act < -log(thr + 1e-10)``.  Each pixel keeps the K
passing Gaussians of smallest length (ties to the lower index), in that
order; slot k of an empty pixel holds id -1.  The weights are VoGE's erf
compositing, its self term and ``exp(0.5)`` included:

    w_m = exp(-ow * sum_k exp(-act_k) (erf((l_m - l_k) sqrt(dsd_k + 1e-10)) + 1) / 2)
          * exp(-act_m) * exp(0.5)

and an attribute image is ``sum_k w_k attrs[id_k]``, a silhouette
``min(sum_k w_k, 1)``.

The selection is not differentiable; the values of the selected pairs are
computed again under autograd, so a gradient is that of the closed form at
the selected pairs (what VoGE's backward computes).  Every image is
rendered on its own and every pair test in chunks, so that a scene of
hundreds of thousands of Gaussians fits: a float32 pre-filter with a proven margin (below) finds the
candidate pairs, and the exact test runs on those alone.

Precision: :data:`REF` computes in float64.  :data:`CONTROL` is the same
reference in TF32, the precision below the float32 the configurations
state: float32 arithmetic whose contractions (the dot products of the pair
test, the attribute merge, the similarity) take operands rounded to TF32's
10-bit mantissa, as the tensor cores do with TF32 on.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from portbench.reference.cameras import rays as camera_rays

E_HALF = math.exp(0.5)
EMPTY_ACT = 1e10
# pairs of one pre-filter chunk (rays x Gaussians): 512 MiB of float32
CHUNK_PAIRS = 1 << 27


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool


REF = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest even;
    the gradient passes through the rounding unchanged."""
    x = x.to(torch.float32)
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return x + (((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32) - x.detach())


def dot(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Sum over the last axis of a * b, at ``prec``."""
    if prec.tf32:
        a, b = tf32(a), tf32(b)
    return (a * b).sum(-1)


@contextlib.contextmanager
def _no_tf32():
    """Matrix products in full float32 while the pre-filter runs."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def precisions(sigmas: torch.Tensor) -> torch.Tensor:
    """(P, 3, 3) precisions L = 2 * sigmas of (P,) isotropic or (P, 3, 3)
    inverse sigmas."""
    if sigmas.ndim == 1:
        eye = torch.eye(3, dtype=sigmas.dtype, device=sigmas.device)
        return 2.0 * sigmas[:, None, None] * eye
    return 2.0 * sigmas


def thr_act(thr: float) -> float:
    return -math.log(thr + 1e-10)


@torch.no_grad()
def _passing_pairs(m, L, rays, thr_a, prec):
    """(ray, Gaussian) of every passing pair, sorted by ray, then length,
    then Gaussian.

    The pre-filter: act >= lam_min(L) |m - length r|^2 >= lam_min |m x r|^2
    for a unit r, so a passing pair has |m x r|^2 = |m|^2 (1 - c^2) <
    thr_a / lam_min with c the cosine between m and r.  The test keeps
    every pair with c^2 > 1 - rho2 / |m|^2, rho2 = 1.5 thr_a / lam_min +
    1e-5 |m|^2: float32 rounds c by ~1e-7, which moves 1 - c^2 by ~2e-7,
    well inside that slack."""
    m32 = m.to(torch.float32)
    m2 = (m32 * m32).sum(-1).clamp_min(1e-30)
    # (on the host: the batched solver on the card refuses 300,000 matrices)
    lam_min = torch.linalg.eigvalsh(L.to(torch.float64).cpu()).amin(-1).clamp_min(1e-30)
    lam_min = lam_min.to(m.device)
    rho2 = 1.5 * thr_a / lam_min.to(torch.float32) + 1e-5 * m2
    lim = 1.0 - rho2 / m2
    mhat = (m32 / m2.sqrt()[:, None]).T.contiguous()
    r32 = rays.to(torch.float32)
    n_rays, P = rays.shape[0], m.shape[0]
    step = max(1, CHUNK_PAIRS // max(P, 1))
    out = []
    with _no_tf32():
        for s in range(0, n_rays, step):
            c = r32[s:s + step] @ mhat
            ray_i, g = (c * c > lim[None]).nonzero(as_tuple=True)
            del c
            ray_i = ray_i + s
            r = rays[ray_i].to(prec.dtype)
            mm, LL = m[g].to(prec.dtype), L[g].to(prec.dtype)
            Lr = dot(LL, r[:, None, :], prec)
            ksk = dot(r, Lr, prec)
            length = dot(mm, Lr, prec) / ksk
            d = mm - length[:, None] * r
            Ld = dot(LL, d[:, None, :], prec)
            act = dot(d, Ld, prec)
            ok = act < thr_a
            out.append((ray_i[ok], g[ok], length[ok]))
    ray_i, g, length = (torch.cat(x) for x in zip(*out))
    # ray-major chunks hold (ray, g) in row-major order: two stable sorts
    # give (ray, length, g)
    o = torch.sort(length, stable=True)[1]
    ray_i, g, length = ray_i[o], g[o], length[o]
    o = torch.sort(ray_i, stable=True)[1]
    return ray_i[o], g[o]


def select(m, L, rays, thr: float, K: int, prec: Precision = REF):
    """(ids (n_rays, K) int64, -1 for none; passing pairs) of rays (n_rays,
    3) against Gaussians m (P, 3) centred on the camera, L (P, 3, 3)."""
    ray_i, g = _passing_pairs(m, L, rays, thr_act(thr), prec)
    n_rays = rays.shape[0]
    counts = torch.bincount(ray_i, minlength=n_rays)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(ray_i.numel(), device=rays.device) - starts[ray_i]
    keep = rank < K
    ids = torch.full((n_rays, K), -1, dtype=torch.int64, device=rays.device)
    ids[ray_i[keep], rank[keep]] = g[keep]
    return ids, int(ray_i.numel())


def slot_values(m, L, rays, ids, prec: Precision = REF):
    """(length, act, dsd) of the selected slots (n_rays, K), differentiable
    in m (P, 3), L (P, 3, 3) and rays (n_rays, 3); empty slots hold length
    and act 1e10, dsd 0."""
    valid = ids >= 0
    gi = ids.clamp_min(0)
    mm, LL, r = m[gi], L[gi], rays[:, None, :].expand(-1, ids.shape[1], -1)
    Lr = dot(LL, r[..., None, :], prec)
    ksk = dot(r, Lr, prec)
    length = dot(mm, Lr, prec) / ksk
    d = mm - length[..., None] * r
    act = dot(d, dot(LL, d[..., None, :], prec), prec)
    big = torch.full_like(act, EMPTY_ACT)
    return (torch.where(valid, length, big), torch.where(valid, act, big),
            torch.where(valid, ksk, torch.zeros_like(ksk)))


def weights(length, act, dsd, ow: float = 1.0):
    """VoGE's erf compositing weights (..., K)."""
    ca = (length[..., :, None] - length[..., None, :]) * torch.sqrt(dsd[..., None, :] + 1e-10)
    dens = torch.exp(-act[..., None, :]) * (torch.erf(ca) + 1.0) / 2.0
    return torch.exp(-ow * dens.sum(-1)) * torch.exp(-act) * E_HALF


def merge(w, ids, attrs, prec: Precision = REF, chunk: int = 1 << 14):
    """Attribute image sum_k w_k attrs[id_k] (n_pix, d), in chunks of pixels."""
    parts = []
    for s in range(0, ids.shape[0], chunk):
        i = ids[s:s + chunk]
        rows = attrs[i.clamp_min(0)] * (i >= 0)[..., None].to(attrs.dtype)
        parts.append(dot(w[s:s + chunk, None, :], rows.transpose(1, 2), prec))
    return torch.cat(parts)


@dataclass
class Image:
    """One rendered image: ids and weights (n_pix, K), the attribute image
    (n_pix, d) when attributes were given, the silhouette (n_pix,) and the
    counts the roofline shares are taken from."""
    ids: torch.Tensor
    w: torch.Tensor
    img: torch.Tensor | None
    sil: torch.Tensor
    facts: dict


def render_image(verts, sigmas, R, T, focal, principal, hw, K: int, thr: float = 0.01,
                 attrs=None, prec: Precision = REF, ow: float = 1.0) -> Image:
    """One camera (R (3, 3), T (3,), focal (2,), principal (2,)) over the
    scene verts (P, 3), sigmas (P,) or (P, 3, 3), attrs (P, d) or None,
    all cast to ``prec.dtype``; differentiable in every floating input."""
    dt = prec.dtype
    verts, sigmas = verts.to(dt), sigmas.to(dt)
    r, centre = camera_rays(R.to(dt)[None], T.to(dt)[None], focal.to(dt)[None],
                            principal.to(dt)[None], hw)
    r, centre = r[0], centre[0]
    m = verts - centre
    L = precisions(sigmas)
    ids, pairs = select(m.detach(), L.detach(), r.detach(), thr, K, prec)
    length, act, dsd = slot_values(m, L, r, ids, prec)
    w = weights(length, act, dsd, ow)
    img = None if attrs is None else merge(w, ids, attrs.to(dt), prec)
    sil = torch.clamp(w.sum(-1), max=1.0)
    return Image(ids, w, img, sil, dict(counts(ids), P=verts.shape[0], pairs=pairs))


def counts(ids: torch.Tensor) -> dict:
    """The roofline's counts of selections (n_pix, K): ``valid`` slots,
    ``valid_sq`` (the sum over pixels of their valid slots squared: the
    weights' (j, k) terms), ``pix_valid`` (pixels with a valid slot)."""
    per_pix = (ids >= 0).sum(-1).to(torch.float64)
    return dict(n_pix=ids.shape[0], K=ids.shape[1], valid=float(per_pix.sum()),
                valid_sq=float((per_pix ** 2).sum()), pix_valid=float((per_pix > 0).sum()))
