"""Pose scoring's and refinement's cosine similarity
(``models.pose.feature_similarity``), its kernel and its gradient's kernel
(``ops.cuda_similarity``, ``csrc/similarity.cu``).

On the CPU: the plain version is the expression ``feature_similarity`` had
before the kernel, to the bit; the route (float32, no mask, no gradient
wanted in the target: the wrapper; anything else: the differentiable
expression) and its value and gradient; CPU tensors launch nothing; the
gradient's plain version is autograd of the expression, and the closed form
the gradient's kernel evaluates is its exact VJP in float64.

On the card (marker ``cuda``; this file imports no JAX, so it runs there
without the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_similarity.py

the kernel against the plain version computed in float64 on the same
float32 inputs, within 1e-6 absolute (a pixel's cosine is rounded in
float32, ~1e-7 relative; the mean over pixels is summed in float64), at
pose scoring's shape and layouts, edge shapes and both of its paths (16-byte
loads; the general lane loop for C = 3, C = 130 or misaligned rows); two
calls equal to the bit; one launch a call; no read past the end of either
input (each placed at the very end of mapped memory, so such a read faults).
The gradient's kernel likewise against autograd of the plain version in
float64, within 2e-6 of each row's scale (``cuda_common.sim_grad_err``), at
pose refinement's shape (a target an image) and the same edge shapes and
layouts, with all-zero rows; two calls equal to the bit; the route under a
gradient: one launch of each a call.
"""
import pytest
import torch

from voge_tpu_torch import trace
from voge_tpu_torch.models import pose
from voge_tpu_torch.ops import cuda_similarity
from voge_tpu_torch.ops.cuda_similarity import (
    feature_similarity, feature_similarity_grad, feature_similarity_grad_plain,
    feature_similarity_plain,
)

from cuda_common import AtTheEnd, sim_grad_err

torch.set_num_threads(2)

ATOL = 1e-6


def expression(pred, target, mask=None):
    """``feature_similarity``'s body before the kernel, as it stood."""
    pn = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + 1e-8)
    tn = target / (torch.linalg.norm(target, dim=-1, keepdim=True) + 1e-8)
    sim = (pn * tn).sum(-1)
    if mask is not None:
        return (sim * mask).sum((1, 2)) / (mask.sum((1, 2)) + 1e-8)
    return sim.mean((1, 2))


def maps(shape, device, seed, tb=1, zero_rows=False):
    """pred (shape) near a target (tb, H, W, C): cosines well away from 0."""
    g = torch.Generator(device).manual_seed(seed)
    target = torch.randn((tb,) + tuple(shape[1:]), generator=g, device=device)
    pred = 0.8 * target + torch.randn(shape, generator=g, device=device)
    if zero_rows:
        pred[:, 1, :3] = 0.0
        target[:, 2, 1] = 0.0
    return pred, target


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["expanded", "per_batch"])
def test_plain_version_is_the_expression_to_the_bit(masked, layout):
    pred, target = maps((3, 5, 7, 6), "cpu", 0, tb=3 if layout == "per_batch" else 1)
    if layout == "expanded":
        target = target.expand(pred.shape)
    mask = (torch.rand(3, 5, 7, generator=torch.Generator().manual_seed(1)) < 0.5).float()
    mask = mask if masked else None
    assert torch.equal(feature_similarity_plain(pred, target, mask),
                       expression(pred, target, mask))
    assert torch.equal(pose.feature_similarity(pred, target, mask), expression(pred, target, mask))


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    pred, target = maps((4, 6, 5, 8), "cpu", 2)
    with trace.tracing(), torch.no_grad():
        got = pose.feature_similarity(pred, target.expand(pred.shape))
        direct = feature_similarity(pred[:, :3], target.expand(pred.shape)[:, :3])
        assert trace.counts().get("launch.feature_similarity", 0) == 0
    assert torch.equal(got, expression(pred, target.expand(pred.shape)))
    assert torch.equal(direct, expression(pred[:, :3], target.expand(pred.shape)[:, :3]))


def counted_routes(monkeypatch):
    """Calls of the wrapper and of the plain version, counted."""
    calls = {"wrapper": 0, "plain": 0}
    for name, key in (("feature_similarity", "wrapper"), ("feature_similarity_plain", "plain")):
        real = getattr(cuda_similarity, name)

        def fn(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(cuda_similarity, name, fn)
    return calls


@pytest.mark.parametrize("case,wrapper", [
    ("no_grad", True), ("leaves_without_grad", True), ("pred_needs_grad", True),
    ("target_needs_grad", False), ("mask", False), ("float64", False),
])
def test_route_by_what_the_input_shows(monkeypatch, case, wrapper):
    """Float32, no mask and no gradient wanted in the target go to the
    wrapper (on CPU tensors it runs the plain version); a target that needs
    a gradient, a mask or another dtype keep the expression.  Every route on
    CPU tensors ends in the plain version once, launches nothing, and gives
    the expression's value and gradient to the bit."""
    calls = counted_routes(monkeypatch)
    pred, target = maps((2, 4, 3, 5), "cpu", 3)
    mask = None
    if case == "pred_needs_grad":
        pred.requires_grad_(True)
    elif case == "target_needs_grad":
        target.requires_grad_(True)
    elif case == "mask":
        mask = torch.ones(2, 4, 3)
    elif case == "float64":
        pred, target = pred.double(), target.double()
    with trace.tracing(), torch.no_grad() if case == "no_grad" else torch.enable_grad():
        got = pose.feature_similarity(pred, target, mask)
        if got.requires_grad:
            got.sum().backward()
        counts = trace.counts()
    assert calls == {"wrapper": int(wrapper), "plain": 1}
    assert counts.get("launch.feature_similarity", 0) == 0
    assert counts.get("launch.feature_similarity_grad", 0) == 0
    assert torch.equal(got, expression(pred.detach(), target.detach(), mask))
    for x in (pred, target):
        if x.requires_grad:
            x2 = x.detach().clone().requires_grad_(True)
            args = (x2, target) if x is pred else (pred, x2)
            expression(*args, mask).sum().backward()
            assert torch.equal(x.grad, x2.grad)


def test_gradient_route_keeps_the_expression_and_its_gradient():
    """``refine_pose``'s route on CPU tensors: the gradient through
    ``feature_similarity`` equals the expression's to the bit, and float64
    autograd's to 1e-6."""
    pred, target = maps((2, 4, 6, 5), "cpu", 4)
    grads = []
    for fn in (pose.feature_similarity, expression):
        p = pred.clone().requires_grad_(True)
        fn(p, target).sum().backward()
        grads.append(p.grad)
    assert torch.equal(grads[0], grads[1])
    p64 = pred.double().requires_grad_(True)
    expression(p64, target.double()).sum().backward()
    torch.testing.assert_close(grads[0].double(), p64.grad, rtol=0, atol=1e-6)


def closed_form(pred, target, grad):
    """The gradient as ``cos_grad_kernel`` evaluates it, staged as its
    source's note says: with s = g / n_pix, r = s / (|t| + 1e-8) and
    q = |p| + 1e-8, (r / q) t - [|p| > 0] (r dot(p, t) / q^2 / |p|) p."""
    n_pix = pred.shape[1] * pred.shape[2]
    target = target.expand(pred.shape)
    dot = (pred * target).sum(-1, keepdim=True)
    np_ = torch.sqrt((pred * pred).sum(-1, keepdim=True))
    q = np_ + 1e-8
    r = (grad / n_pix)[:, None, None, None] / (torch.sqrt((target * target).sum(-1, keepdim=True))
                                               + 1e-8)
    c = torch.where(np_ > 0, -(r * dot) / (q * q) / np_, torch.zeros_like(np_))
    return (r / q) * target + c * pred


@pytest.mark.parametrize("shape,tb,zero_rows", [
    ((3, 5, 7, 6), 3, False),       # a target an image
    ((3, 5, 7, 6), 1, True),        # one target for the batch; background pixels, empty targets
    ((2, 4, 4, 3), 2, True),        # C = 3
])
def test_kernel_closed_form_is_the_expressions_gradient(shape, tb, zero_rows):
    """In float64 the closed form the gradient's kernel evaluates equals
    autograd of the expression to ~1e-15 of each row's scale, at a zero
    pred row (the norm's gradient 0 there, the first term 1e8 times a
    foreground pixel's) and a zero target row too."""
    pred, target = maps(shape, "cpu", 12, tb=tb, zero_rows=zero_rows)
    pred, target = pred.double(), target.double()
    grad = torch.tensor([-1.0, 0.5, 2.0][:shape[0]], dtype=torch.float64)
    want = feature_similarity_grad_plain(pred, target, grad)
    got = closed_form(pred, target, grad)
    n_pix = shape[1] * shape[2]
    scale = (n_pix / grad.abs())[:, None, None, None] * (torch.linalg.norm(pred, dim=-1,
                                                                           keepdim=True) + 1e-8)
    assert ((got - want) * scale).abs().max().item() < 1e-12
    if zero_rows:
        assert want[:, 1, :3].abs().min() > 1e3 * want[:, 0].abs().max()


@pytest.mark.parametrize("layout", ["per_image", "shared", "grad_expanded"])
def test_grad_wrapper_on_cpu_tensors_is_autograd_of_the_expression(layout):
    """``feature_similarity_grad`` on CPU tensors runs its plain version,
    autograd of the expression, to the bit, and launches nothing; a grad of
    one value expanded (a sum's gradient) as well."""
    pred, target = maps((3, 4, 5, 8), "cpu", 13, tb=1 if layout == "shared" else 3)
    if layout == "shared":
        target = target.expand(pred.shape)
    grad = torch.tensor([-1.0, 0.25, 3.0])
    if layout == "grad_expanded":
        grad = torch.tensor(-1.0).expand(3)
    with trace.tracing():
        got = feature_similarity_grad(pred, target, grad)
        assert trace.counts().get("launch.feature_similarity_grad", 0) == 0
    p = pred.clone().requires_grad_(True)
    expression(p, target).backward(grad)
    assert got.shape == pred.shape and torch.equal(got, p.grad)


# ---- on the card ----

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def launched():
    return trace.counts().get("launch.feature_similarity", 0)


def held(pred, target):
    """The kernel on (pred, target) against the plain version in float64 on
    the same values; two calls equal to the bit, one launch each."""
    with trace.tracing():
        got = feature_similarity(pred, target)
        again = feature_similarity(pred, target)
        torch.cuda.synchronize()
        assert launched() == 2
    want = feature_similarity_plain(pred.double(), target.double())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=ATOL)
    return got


@pytest.mark.cuda
def test_kernel_at_score32_shape_with_a_shared_target(dev):
    """Pose scoring's call: (32, 256, 256, 128) against one map expanded
    (batch stride 0), and its ``half_batch`` fault's view ``[:, :128]``."""
    pred, target = maps((32, 256, 256, 128), dev, 5)
    expanded = target.expand(pred.shape)
    assert expanded.stride(0) == 0
    got = held(pred, expanded)
    assert got.min() > 0.5
    half = held(pred[:, :128], expanded[:, :128])
    assert not torch.equal(got, half)


EDGE_SHAPES = [
    ((5, 7, 9, 128), 5),          # a distinct target per batch, odd B, a ragged tile
    ((40, 3, 30, 64), 1),         # B over one block's 32 batches
    ((1, 16, 16, 128), 1),        # B = 1
    ((3, 11, 13, 4), 3),          # the narrowest vectorised row
    ((4, 9, 10, 3), 1),           # C = 3: the general lane loop
    ((4, 9, 10, 130), 4),         # C = 130: the general lane loop
]
PAST_END_SHAPES = [
    ((31, 128, 128, 128), 31),    # a target per batch, odd B: the unrolled loop's last step
    ((5, 7, 9, 128), 5),
    ((33, 9, 10, 128), 33),       # a second block of one batch
    ((31, 128, 128, 128), 1),     # one target for the batch (batch stride 0)
    ((5, 9, 10, 130), 5),         # the general lane loop
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tb", EDGE_SHAPES)
def test_kernel_edge_shapes(dev, shape, tb):
    pred, target = maps(shape, dev, 6, tb=tb)
    held(pred, target)                       # (tb, H, W, C): broadcast by the wrapper if tb = 1
    if tb == 1:
        held(pred, target.expand(shape))     # batch stride 0


@pytest.mark.cuda
def test_kernel_zero_rows_and_other_layouts(dev):
    """All-zero pixel rows give 0 as the expression does; rows that are not
    dense or not 16-byte aligned are copied or take the general loop."""
    pred, target = maps((6, 8, 8, 32), dev, 7, zero_rows=True)
    held(pred, target.expand(pred.shape))
    wide, _ = maps((6, 8, 8, 33), dev, 8)
    held(wide[..., 1:], target.expand(pred.shape))             # rows not dense: a copy
    flat = torch.empty(pred.numel() + 1, device=dev)
    shifted = flat[1:].view(pred.shape)
    shifted.copy_(pred)
    assert shifted.data_ptr() % 16 != 0
    held(shifted, target.expand(pred.shape))                   # misaligned: the lane loop
    held(pred.permute(0, 2, 1, 3), target.expand(pred.shape))  # H and W swapped: a copy


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tb", PAST_END_SHAPES)
def test_kernel_reads_nothing_past_its_inputs(dev, shape, tb):
    """pred and target each end at the end of mapped memory, so the kernel
    reading one byte past either would fault."""
    pred, target = maps(shape, dev, 10, tb=tb)
    bufs = [AtTheEnd(t.numel(), dev) for t in (pred, target)]
    try:
        p_end, t_end = (b.tensor.view(t.shape) for b, t in zip(bufs, (pred, target)))
        p_end.copy_(pred)
        t_end.copy_(target)
        got = held(p_end, t_end if tb > 1 else t_end.expand(shape))
        torch.cuda.synchronize()
        assert torch.equal(got, feature_similarity(pred, target.expand(shape)))
    finally:
        for b in bufs:
            b.free()


# ---- the gradient's kernel on the card ----

def grad_launched():
    return trace.counts().get("launch.feature_similarity_grad", 0)


def grads_of(B, dev):
    """A gradient of the batch's similarities: signs and sizes that differ."""
    return torch.tensor([(-1.0) ** b * (1.0 + b / B) for b in range(B)], device=dev)


def held_grad(pred, target, grad=None):
    """The gradient's kernel on (pred, target, grad) against autograd of the
    plain version in float64 on the same values (``sim_grad_err``); two
    calls equal to the bit, one launch each; the cotangent dense, pred's
    shape."""
    grad = grads_of(pred.shape[0], pred.device) if grad is None else grad
    with trace.tracing():
        got = feature_similarity_grad(pred, target, grad)
        again = feature_similarity_grad(pred, target, grad)
        torch.cuda.synchronize()
        assert grad_launched() == 2
    assert got.dtype == torch.float32 and got.shape == pred.shape and got.is_contiguous()
    assert torch.equal(got, again)
    want = feature_similarity_grad_plain(pred.double(), target.double(), grad.double())
    sim_grad_err(got, want, pred, grad, "feature_similarity_grad")
    return got


@pytest.mark.cuda
def test_grad_kernel_at_refine_b32_shape(dev):
    """Pose refinement's call: (32, 256, 256, 128) against a target an image,
    the gradient of ``-sim.sum()`` (one value expanded, stride 0); and
    against one target for the batch (batch stride 0)."""
    pred, target = maps((32, 256, 256, 128), dev, 23, tb=32)
    grad = torch.tensor(-1.0, device=dev).expand(32)
    assert grad.stride(0) == 0
    held_grad(pred, target, grad)
    held_grad(pred, target[:1].expand(pred.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tb", EDGE_SHAPES)
def test_grad_kernel_edge_shapes(dev, shape, tb):
    pred, target = maps(shape, dev, 24, tb=tb)
    held_grad(pred, target)
    if tb == 1:
        held_grad(pred, target.expand(shape))


@pytest.mark.cuda
def test_grad_kernel_zero_rows_and_other_layouts(dev):
    """All-zero pred rows (the norm's gradient 0, the first term alone) and
    target rows; a sliced pred and target with their own batch strides
    (no copy); rows not dense or H and W swapped (a copy); rows not 16-byte
    aligned (the general loop)."""
    pred, target = maps((7, 8, 8, 32), dev, 25, tb=7, zero_rows=True)
    got = held_grad(pred, target)
    assert got[:, 1, :3].abs().min() > 1e3 * got[:, 0].abs().max()
    held_grad(pred, target[:1].expand(pred.shape))
    sliced = pred[:, :5]
    assert sliced.stride(0) == 8 * 8 * 32 and sliced[0].is_contiguous()
    held_grad(sliced, target[:, :5])
    wide, _ = maps((7, 8, 8, 33), dev, 26)
    held_grad(wide[..., 1:], target)
    flat = torch.empty(pred.numel() + 1, device=dev)
    shifted = flat[1:].view(pred.shape)
    shifted.copy_(pred)
    assert shifted.data_ptr() % 16 != 0
    held_grad(shifted, target)
    held_grad(pred.permute(0, 2, 1, 3), target)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tb", PAST_END_SHAPES)
def test_grad_kernel_reads_nothing_past_its_inputs(dev, shape, tb):
    """pred, target and grad each end at the end of mapped memory, so the
    gradient's kernel reading one byte past any would fault."""
    pred, target = maps(shape, dev, 27, tb=tb)
    grad = grads_of(shape[0], dev)
    bufs = [AtTheEnd(t.numel(), dev) for t in (pred, target, grad)]
    try:
        p_end, t_end, g_end = (b.tensor.view(t.shape) for b, t in zip(bufs, (pred, target, grad)))
        for end, t in zip((p_end, t_end, g_end), (pred, target, grad)):
            end.copy_(t)
        got = held_grad(p_end, t_end if tb > 1 else t_end.expand(shape), g_end)
        torch.cuda.synchronize()
        assert torch.equal(got, feature_similarity_grad(pred, target.expand(shape), grad))
    finally:
        for b in bufs:
            b.free()


@pytest.mark.cuda
def test_each_image_of_a_batch_as_alone(dev):
    """``refine_pose`` over a batch is B refinements: each image's similarity
    and gradient, from the batch's call, equal to the bit those of the image
    alone (a batch of one: its target at batch stride 0), at refinement's
    (8, 256, 256, 128) with a target an image."""
    pred, target = maps((8, 256, 256, 128), dev, 28, tb=8)
    grad = torch.tensor(-1.0, device=dev).expand(8)
    sim = feature_similarity(pred, target)
    cot = feature_similarity_grad(pred, target, grad)
    for b in range(8):
        assert torch.equal(feature_similarity(pred[b:b + 1], target[b:b + 1]), sim[b:b + 1]), b
        assert torch.equal(feature_similarity_grad(pred[b:b + 1], target[b:b + 1], grad[:1]),
                           cot[b:b + 1]), b


@pytest.mark.cuda
def test_score_and_refine_launch_the_kernels(dev):
    """Under ``no_grad`` (``score``) ``feature_similarity`` launches the
    forward once a call; with pred needing a gradient (``refine_pose``) the
    forward once and, in the backward, the gradient's kernel once, its
    value the no-gradient call's to the bit and its gradient autograd's of
    the expression; a target that needs a gradient, or a mask, launch
    nothing and keep the expression; the wrapper refuses a target that
    needs a gradient."""
    pred, target = maps((4, 16, 16, 128), dev, 9)
    with trace.tracing():
        with torch.no_grad():
            got = pose.feature_similarity(pred, target.expand(pred.shape))
        assert launched() == 1 and grad_launched() == 0
        p = pred.clone().requires_grad_(True)
        val = pose.feature_similarity(p, target)
        assert launched() == 2 and grad_launched() == 0
        (-val.sum()).backward()
        assert launched() == 2 and grad_launched() == 1
        t = target.clone().requires_grad_(True)
        by_t = pose.feature_similarity(pred, t)
        by_mask = pose.feature_similarity(p, target, torch.ones(4, 16, 16, device=dev))
        assert launched() == 2 and grad_launched() == 1
    assert torch.equal(got, val.detach())
    want = feature_similarity_grad_plain(pred.double(), target.double(),
                                         -torch.ones(4, dtype=torch.float64, device=dev))
    sim_grad_err(p.grad, want, pred, -torch.ones(4, device=dev), "refine's route")
    assert torch.equal(by_t, expression(pred, t)) and torch.equal(by_mask, expression(
        p, target, torch.ones(4, 16, 16, device=dev)))
    with pytest.raises(ValueError, match="target"):
        feature_similarity(p, t)
