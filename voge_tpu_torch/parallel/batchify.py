"""Memory-bounded chunked execution (counterpart of
``voge_tpu/parallel/batchify.py`` and the reference ``Batchifier``,
``Utils.py:59-176``): designated keyword arguments are reshaped so that a set
of target dims ravels into one axis, that axis is sliced into chunks of
``batch_size``, the wrapped function runs per chunk, and its outputs are
concatenated and reshaped back.  It bounds the memory of dense (rays x
Gaussians) products.  ``pad_to_full_chunks=True`` pads the last chunk (by
repeating its edge) to ``batch_size`` and crops the outputs, so every call
sees the same shapes."""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch


def _normalize_dims(shape, target_dims, remain_dims):
    nd = len(shape)
    if target_dims is not None:
        if isinstance(target_dims, int):
            target_dims = (target_dims,)
        return tuple(d if d >= 0 else nd + d for d in target_dims)
    if isinstance(remain_dims, int):
        remain_dims = (remain_dims,)
    other = tuple(d if d >= 0 else nd + d for d in remain_dims)
    return tuple(i for i in range(nd) if i not in other)


def _ravel_spec(shape, this_dims):
    """Collapse the contiguous target dims into one -1 axis (reference
    ``Utils.py:129-136``: the target dims must be contiguous)."""
    to_shape = [shape[i] if i not in this_dims else -1 for i in range(len(shape))]
    for j in range(len(to_shape) - 1, 0, -1):
        if j < len(to_shape) and to_shape[j] == -1 and to_shape[j - 1] == -1:
            del to_shape[j]
    if to_shape.count(-1) != 1:
        raise ValueError("batchify: the target dims must be contiguous")
    return to_shape, to_shape.index(-1)


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def batchify(fn: Callable, batch_size: int, batch_args: Union[str, Sequence[str]],
             target_dims: Union[int, Sequence[int], None] = None,
             remain_dims: Union[int, Sequence[int], None] = None,
             pad_to_full_chunks: bool = True) -> Callable:
    """Chunk the keyword arguments ``batch_args`` of ``fn`` along their
    raveled target dims (``target_dims``, or every dim but ``remain_dims``).

    Outputs: tensors are concatenated along the raveled axis and reshaped to
    the arguments' leading shape; Python numbers and 0-d tensors are summed
    over the chunks; a tuple output is handled element by element."""
    if isinstance(batch_args, str):
        batch_args = (batch_args,)
    batch_args = tuple(batch_args)
    if not batch_args:
        raise ValueError("batchify: no batch_args")

    def wrapper(*args, **kwargs):
        kwargs = dict(kwargs)
        total_len, recorded_shape, save_idx = -1, None, None
        for k in batch_args:
            get = kwargs[k]
            this_dims = _normalize_dims(get.shape, target_dims, remain_dims)
            to_shape, s_idx = _ravel_spec(get.shape, this_dims)
            to_record = tuple(get.shape[0:to_shape.index(-1) + len(this_dims)])
            if recorded_shape is None:
                recorded_shape, save_idx = to_record, s_idx
            elif recorded_shape != to_record:
                raise ValueError(f"batchify: {k} has leading shape {to_record}, "
                                 f"expected {recorded_shape}")
            kwargs[k] = get.reshape(to_shape)
            total_len = kwargs[k].shape[s_idx]
        if total_len < 0:
            raise ValueError("batchify: no batchify parameters found")

        out = []
        for start in range(0, total_len, batch_size):
            stop = min(start + batch_size, total_len)
            short = pad_to_full_chunks and stop - start < batch_size
            this_kwargs = dict(kwargs)
            for k in batch_args:
                chunk = kwargs[k].narrow(save_idx, start, stop - start)
                if short:
                    edge = chunk.narrow(save_idx, stop - start - 1, 1)
                    reps = [1] * chunk.ndim
                    reps[save_idx] = batch_size - (stop - start)
                    chunk = torch.cat([chunk, edge.repeat(reps)], dim=save_idx)
                this_kwargs[k] = chunk
            res = fn(*args, **this_kwargs)
            if short:
                res = _map(lambda x: x.narrow(save_idx, 0, stop - start)
                           if isinstance(x, torch.Tensor) and x.ndim > save_idx else x, res)
            out.append(res)

        def reshape_out(parts):
            if isinstance(parts[0], (float, int)):
                return sum(parts)
            if isinstance(parts[0], torch.Tensor) and parts[0].ndim == 0:
                return torch.stack(parts).sum()
            x = torch.cat(parts, dim=save_idx) if len(parts) > 1 else parts[0]
            return x.reshape(*recorded_shape, *x.shape[save_idx + 1:])

        if isinstance(out[0], tuple):
            return tuple(reshape_out([o[i] for o in out]) for i in range(len(out[0])))
        return reshape_out(out)

    return wrapper


class Batchifier:
    """Decorator form (reference ``Utils.py:80``): ``Batchifier(batch_size,
    batch_args, ...)(func)`` is ``batchify(func, ...)``."""

    def __init__(self, batch_size: int, batch_args: Union[str, Sequence[str]],
                 target_dims=None, remain_dims=None, **kwargs):
        self.batch_size = batch_size
        self.batch_args = batch_args
        self.target_dims = target_dims
        self.remain_dims = remain_dims

    def __call__(self, func):
        return batchify(func, self.batch_size, self.batch_args,
                        self.target_dims, self.remain_dims)
