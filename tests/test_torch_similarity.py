"""Pose scoring's cosine similarity (``models.pose.feature_similarity``) and
its kernel (``ops.cuda_similarity``, ``csrc/similarity.cu``).

On the CPU: the plain version is the expression ``feature_similarity`` had
before the kernel, to the bit; the route (float32, no mask, no gradient
wanted: the wrapper; anything else: the differentiable expression) and its
gradient; CPU tensors launch nothing.

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
"""
import ctypes

import pytest
import torch

from voge_tpu_torch import trace
from voge_tpu_torch.models import pose
from voge_tpu_torch.ops import cuda_similarity
from voge_tpu_torch.ops.cuda_similarity import feature_similarity, feature_similarity_plain

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


@pytest.mark.parametrize("case,wrapper", [
    ("no_grad", True), ("leaves_without_grad", True), ("pred_needs_grad", False),
    ("target_needs_grad", False), ("mask", False), ("float64", False),
])
def test_route_by_what_the_input_shows(monkeypatch, case, wrapper):
    """Float32, no mask and no gradient wanted go to the wrapper; a gradient
    wanted, a mask or another dtype keep the expression."""
    calls = []
    real = cuda_similarity.feature_similarity
    monkeypatch.setattr(cuda_similarity, "feature_similarity",
                        lambda p, t: calls.append(1) or real(p, t))
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
    with torch.no_grad() if case == "no_grad" else torch.enable_grad():
        got = pose.feature_similarity(pred, target, mask)
    assert len(calls) == int(wrapper)
    assert torch.equal(got, expression(pred, target, mask))


def test_gradient_route_keeps_the_expression_and_its_gradient():
    """``refine_pose``'s route: the gradient through ``feature_similarity``
    equals the expression's to the bit, and float64 autograd's to 1e-6."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tb", [
    ((5, 7, 9, 128), 5),          # a distinct target per batch, odd B, a ragged tile
    ((40, 3, 30, 64), 1),         # B over one block's 32 batches
    ((1, 16, 16, 128), 1),        # B = 1
    ((3, 11, 13, 4), 3),          # the narrowest vectorised row
    ((4, 9, 10, 3), 1),           # C = 3: the general lane loop
    ((4, 9, 10, 130), 4),         # C = 130: the general lane loop
])
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


class _Prop(ctypes.Structure):      # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32_meta", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _Access(ctypes.Structure):    # CUmemAccessDesc
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int), ("flags", ctypes.c_int)]


class _AtTheEnd:
    """``n`` float32 on the card whose last one ends where mapped memory
    ends: CUDA's virtual memory API (the driver, through ctypes) reserves a
    granule more than it maps, so a read past the end faults with an illegal
    address instead of reading a neighbour's bytes in the caching
    allocator's block.  ``tensor`` views it; ``free`` unmaps it."""

    def __init__(self, n, device):
        cu = self.cu = ctypes.CDLL("libcuda.so.1")
        u64, size = ctypes.c_uint64, ctypes.c_size_t
        prop = _Prop(type=1, loc_type=1, loc_id=device.index or 0)    # pinned, on the device
        gran = size()
        _ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0))
        self.mapped = -(-n * 4 // gran.value) * gran.value
        self.reserved = self.mapped + gran.value
        self.base, self.handle = u64(), u64()
        _ok(cu.cuMemAddressReserve(ctypes.byref(self.base), size(self.reserved), size(0),
                                   u64(0), u64(0)))
        _ok(cu.cuMemCreate(ctypes.byref(self.handle), size(self.mapped), ctypes.byref(prop),
                           u64(0)))
        _ok(cu.cuMemMap(self.base, size(self.mapped), size(0), self.handle, u64(0)))
        access = _Access(loc_type=1, loc_id=prop.loc_id, flags=3)     # read and write
        _ok(cu.cuMemSetAccess(self.base, size(self.mapped), ctypes.byref(access), size(1)))
        ptr = self.base.value + self.mapped - n * 4
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<f4",
                                         "data": (ptr, False), "version": 3}
        self.tensor = torch.as_tensor(self, device=device)
        assert self.tensor.data_ptr() == ptr

    def free(self):
        torch.cuda.synchronize()
        self.tensor = None
        size = ctypes.c_size_t
        _ok(self.cu.cuMemUnmap(self.base, size(self.mapped)))
        _ok(self.cu.cuMemRelease(self.handle))
        _ok(self.cu.cuMemAddressFree(self.base, size(self.reserved)))


def _ok(err):
    assert err == 0, f"CUDA driver error {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tb", [
    ((31, 128, 128, 128), 31),    # a target per batch, odd B: the unrolled loop's last step
    ((5, 7, 9, 128), 5),
    ((33, 9, 10, 128), 33),       # a second block of one batch
    ((31, 128, 128, 128), 1),     # one target for the batch (batch stride 0)
    ((5, 9, 10, 130), 5),         # the general lane loop
])
def test_kernel_reads_nothing_past_its_inputs(dev, shape, tb):
    """pred and target each end at the end of mapped memory, so the kernel
    reading one byte past either would fault."""
    pred, target = maps(shape, dev, 10, tb=tb)
    bufs = [_AtTheEnd(t.numel(), dev) for t in (pred, target)]
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


@pytest.mark.cuda
def test_score_launches_the_kernel_and_refine_keeps_the_expression(dev):
    """Under ``no_grad`` (``score``) ``feature_similarity`` launches once a
    call; with a gradient wanted (``refine_pose``) it launches nothing and
    the gradient is the expression's."""
    pred, target = maps((4, 16, 16, 128), dev, 9)
    with trace.tracing():
        with torch.no_grad():
            got = pose.feature_similarity(pred, target.expand(pred.shape))
        assert launched() == 1
        p = pred.clone().requires_grad_(True)
        val = pose.feature_similarity(p, target)
        val.sum().backward()
        assert launched() == 1
    torch.testing.assert_close(got, val.detach(), rtol=0, atol=ATOL)
    p2 = pred.clone().requires_grad_(True)
    expression(p2, target).sum().backward()
    assert torch.equal(p.grad, p2.grad)
