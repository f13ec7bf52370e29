"""``voge_tpu_torch.timing`` on the CPU (``time.perf_counter``; CUDA events
take over on the card, in ``tests/test_torch_cuda.py``): ``voge_tpu``'s
keys, in seconds per call, and ``args_fn`` called with a rising ``i``, once
per call and before the clock starts.  Calls whose arguments hold no CPU
tensor name the CPU with ``device="cpu"``."""
import time

import numpy as np
import pytest
import torch

from voge_tpu_torch import timing

KEYS = {"median", "estimates", "spread", "iqr_spread"}


def test_keys_and_rising_args():
    seen, calls = [], []

    def args_fn(i):
        seen.append(i)
        return (torch.full((4,), float(i)),)

    def fn(x):
        calls.append(float(x[0]))
        time.sleep(0.002)
        return x * 2

    out = timing.measure_stats(fn, args_fn=args_fn, n=5, warmup=2)
    assert set(out) == KEYS
    assert seen == list(range(7)) and calls == [float(i) for i in range(7)]
    assert len(out["estimates"]) == 5
    assert all(0.0015 < e < 1.0 for e in out["estimates"])
    assert out["median"] == float(np.median(out["estimates"]))
    assert out["spread"] == pytest.approx(max(out["estimates"]) / min(out["estimates"]) - 1)
    q25, q75 = np.percentile(out["estimates"], [25, 75])
    assert out["iqr_spread"] == pytest.approx((q75 - q25) / out["median"])


def test_args_list_cycles_and_measure_is_the_median():
    seen = []
    args = [(1,), (2,), (3,)]
    out = timing.measure_stats(lambda a: seen.append(a), args_list=args, n=4, device="cpu")
    assert seen == [1, 2, 3, 1, 2] and len(out["estimates"]) == 4
    t = timing.measure(lambda a: time.sleep(0.001), args_list=[(0,)], n=3, device="cpu")
    assert 0.0005 < t < 1.0


def test_one_call_has_no_spread_and_bad_arguments_raise():
    out = timing.measure_stats(lambda: None, args_list=[()], n=1, warmup=0, device="cpu")
    assert out["spread"] == 0.0 == out["iqr_spread"] and len(out["estimates"]) == 1
    with pytest.raises(ValueError):
        timing.measure_stats(lambda: None)
    with pytest.raises(ValueError):
        timing.measure_stats(lambda: None, args_list=[()], n=0, device="cpu")


def test_the_card_is_the_default_device():
    """With no tensor among the arguments and no ``device``, the card is
    assumed (the port's device rule): here, without one, the CUDA call
    fails with PyTorch's CUDA error."""
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia|torch not compiled"):
        timing.measure_stats(lambda: None, args_list=[()], n=1, warmup=0)
