"""The card's peaks and the least time a layer's work could take on it.

A layer's bound is the larger of its bytes over the memory's rate and its
operations over float32's rate outside the tensor cores.  Bytes count each
input read once and each output written once; operations are counted per
unit of work.  Every count comes from the cell's inputs and from the
outputs as the reference defines them (the passing pairs, the valid slots,
the pixels with a valid slot, K), never from a count the program reports,
so a change to how a kernel works leaves the bound the same.

Each render of a step is a dict of the reference's counts (``n_pix``,
``K``, ``P``, ``pairs``, ``valid``, ``valid_sq``: the sum over pixels of
their valid slots squared, ``pix_valid``) with what the step does to it:
``weight`` (renders of the step per render counted), ``d_select`` (the
attribute width the select composites, 0 for none), ``bwd`` (None, "full":
the Gaussians' gradients, or "rays": the rays' alone), ``d_bwd`` (the
attribute width the fine backward takes), ``rays_grad``, ``merge_d`` (the
attribute merge's width, 0 for none), ``dw`` (the merge's weight
gradient), ``dattr`` (its attribute gradient).
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): HBM3 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s.  Both assume the 700 W power limit.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
F32 = 4
# Operations per unit of work (multiplies, adds, divisions and
# transcendental calls each counted once a result):
# one (ray, Gaussian) pair test: m^T L r 5, r^T L r 17, the length 1, the
# residual 6, act 15, the comparison 5;
PAIR_FLOPS = 49
# one (j, k) term of the erf compositing: the difference, its scale, erf,
# three more;
WEIGHT_FLOPS = 6
# one (j, k) term of the weights' backward (erf, exp and ~16 multiply-adds);
FOLD_FLOPS = 18
# a slot's chain rule: the Gaussian's gradients and the ray's around the
# residual, and the ray's side alone;
SLOT_BWD_FLOPS = 150
SLOT_RAY_FLOPS = 40
# a Gaussian's mean and precision as the pair test reads them
GAUSS_BYTES = 12 * F32


def bound_ms(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_S, flops / FP32_FLOP_S) * 1e3


def select_ms(renders) -> float | None:
    """The select: the rays and the Gaussians read, K slots a pixel of
    id, length and weight written (and act and dsd where a backward reads
    them), the composited attributes; a pair test for every passing pair
    (any may enter the K kept), the weights' (j, k) terms, 2 d a slot."""
    total = 0.0
    for r in renders:
        outs = 3 + (2 if r["bwd"] else 0)
        by = (r["n_pix"] * 3 * F32 + r["P"] * GAUSS_BYTES + outs * r["n_pix"] * r["K"] * F32
              + r["n_pix"] * r["d_select"] * F32 + r["P"] * r["d_select"] * F32)
        ops = (r["pairs"] * PAIR_FLOPS + r["valid_sq"] * WEIGHT_FLOPS
               + r["valid"] * 2 * r["d_select"])
        total += r["weight"] * bound_ms(by, ops)
    return total


def fine_bwd_ms(renders) -> float | None:
    """The fine backward: the rays, the slots' id, length, dsd, weight and
    the weights' cotangent read, the Gaussians (and their attribute rows
    with the image's cotangent where it takes them); the Gaussians'
    gradients (and their attribute rows') or the rays' written; the weight
    terms and each valid slot's chain rule."""
    total, seen = 0.0, False
    for r in renders:
        if not r["bwd"]:
            continue
        seen = True
        d, full = r["d_bwd"], r["bwd"] == "full"
        by = (r["n_pix"] * 3 * F32 + 5 * r["n_pix"] * r["K"] * F32 + r["P"] * GAUSS_BYTES
              + (r["P"] * d * F32 + r["n_pix"] * d * F32 if d else 0)
              + (r["P"] * (GAUSS_BYTES + d * F32) if full else 0)
              + (r["n_pix"] * 3 * F32 if r["rays_grad"] else 0))
        ops = r["valid_sq"] * FOLD_FLOPS + r["valid"] * (
            (SLOT_BWD_FLOPS if full else SLOT_RAY_FLOPS) + 4 * d)
        total += r["weight"] * bound_ms(by, ops)
    return total if seen else None


def attr_ms(renders) -> float | None:
    """The attribute merge and its backward.  Forward: the ids read whole,
    the valid slots' weights, the attribute rows, the image written; 2 d
    operations a valid slot.  The weights' gradient: the ids read and the
    weights' cotangent written whole, the attribute rows, the image
    cotangent's rows of the pixels with a valid slot; 2 d a valid slot.
    The attributes' gradient: the ids and valid weights, those cotangent
    rows, the attribute gradient's rows written; 2 d a valid slot."""
    total, seen = 0.0, False
    for r in renders:
        d = r["merge_d"]
        if not d:
            continue
        seen = True
        ids = r["n_pix"] * r["K"] * F32
        rows = r["P"] * d * F32
        by = ids + r["valid"] * F32 + rows + r["n_pix"] * d * F32
        ops = r["valid"] * 2 * d
        if r["dw"]:
            by += 2 * ids + rows + r["pix_valid"] * d * F32
            ops += r["valid"] * 2 * d
        if r["dattr"]:
            by += ids + r["valid"] * F32 + r["pix_valid"] * d * F32 + rows
            ops += r["valid"] * 2 * d
        total += r["weight"] * bound_ms(by, ops)
    return total if seen else None
