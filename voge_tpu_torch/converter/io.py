"""OFF / COFF / GOFF file IO (counterpart of ``voge_tpu/converter/io.py``,
itself byte-compatible with the reference ``VoGE/Converter/IO.py``): the
files either package writes are the same bytes and load in the other.

GOFF ("Gaussian OFF") text format (reference ``IO.py:5-8``)::

    GOFF
    N_vertices sigma_shape(1|3|6|9) if_radian(1|0)
    <N point lines: x y z>
    <N sigma lines>
    [<N radian lines>]

Loaders return numpy arrays, or with ``to_torch=True`` (the reference's
flag) torch tensors on ``device``: None is the card
(``_device.resolve_device``), pass ``device="cpu"`` for the CPU.
:func:`to_torch` puts arrays on a device the same way.  Numbers are parsed with numpy (``voge_tpu`` has a C++
parser for the same job; the port keeps none).
"""
from __future__ import annotations

import numpy as np
import torch

from voge_tpu_torch._device import resolve_device


def _fromtext(text: str, dtype) -> np.ndarray:
    return np.array(text.split(), dtype=dtype)


def load_off(file_name, to_torch: bool = False, ignore_color: bool = False, device=None):
    """Load an OFF / COFF mesh (reference ``IO.py:11-58``).

    After a two-line header the file holds ``n_points`` vertex rows of
    ``3 [+ colour]`` floats, then ``n_faces`` face rows of ``arity idx...
    [colour...]`` ints; the colour columns are split off by width.

    :return: (verts float32, faces int32[, vert_color][, face_color]) numpy
        arrays; with ``to_torch=True`` tensors of the same types on
        ``device`` (None: the card)
    """
    with open(file_name) as file_handle:
        lines = file_handle.readlines()
    head = lines[0]
    has_color = (not ignore_color) and head[:4] == "COFF"
    if not ignore_color and not (has_color or head[:3] == "OFF"):
        raise ValueError("Unsupported OFF format: %s" % head.strip())
    counts = lines[1].split()
    n_points, n_faces = int(counts[0]), int(counts[1])

    vb = _fromtext("".join(lines[2:2 + n_points]), np.float32).reshape((n_points, -1))
    fb = _fromtext("".join(lines[2 + n_points:]), np.int32)
    fb = fb.reshape((n_faces, -1)) if n_faces > 0 else fb.reshape((0, 4))
    arity = int(fb[0, 0]) if n_faces > 0 else 3

    out = [vb[:, 0:3], fb[:, 1:arity + 1]]
    if has_color and vb.shape[1] > 3:
        out.append(vb[:, 3:])
    if has_color and n_faces > 0 and fb.shape[1] > arity + 1:
        out.append(fb[:, arity + 1:])
    if to_torch:
        device = resolve_device(device)
        return tuple(torch.as_tensor(t, device=device) for t in out)
    return tuple(out)


def load_goff(file_name, to_torch: bool = False, device=None):
    """Load a GOFF Gaussian scene (reference ``IO.py:61-88``).

    :return: (points (N, 3), sigma: (N,), (N, 3), a pair of (N, 3) for 6
        columns, or (N, 3, 3); radian (N,) or None), numpy arrays; with
        ``to_torch=True`` tensors on ``device`` (None: the card)
    """
    with open(file_name) as file_handle:
        file_list = file_handle.readlines()
    header = file_list[1].split(" ")
    n_points, l_sigma, if_radian = int(header[0]), int(header[1]), bool(int(header[2]))

    points = _fromtext("".join(file_list[2:2 + n_points]), np.float32).reshape((-1, 3))
    sigma = _fromtext("".join(file_list[2 + n_points:2 + n_points * 2]),
                      np.float32).reshape((-1, l_sigma))
    if l_sigma == 6:
        sigma = tuple(np.split(sigma, [3], axis=1))
    elif l_sigma == 9:
        sigma = sigma.reshape((-1, 3, 3))
    elif l_sigma == 1:
        sigma = sigma.reshape(-1)
    radian = None
    if if_radian:
        radian = _fromtext("".join(file_list[2 + n_points * 2:]), np.float32)
    if to_torch:
        device = resolve_device(device)
        put = lambda t: None if t is None else torch.as_tensor(t, device=device)
        return (put(points),
                tuple(put(s) for s in sigma) if isinstance(sigma, tuple) else put(sigma),
                put(radian))
    return points, sigma, radian


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_off(file_name, vertices, faces, vert_color=None, face_color=None):
    """Save an OFF / COFF mesh (reference ``IO.py:91-126``)."""
    vertices, faces = _np(vertices), _np(faces)
    out = ["OFF\n" if (vert_color is None and face_color is None) else "COFF\n"]
    out.append("%d %d 0\n" % (vertices.shape[0], faces.shape[0]))
    if vert_color is None:
        for v in vertices:
            out.append("%.16f %.16f %.16f\n" % (v[0], v[1], v[2]))
    else:
        for v, c in zip(vertices, _np(vert_color)):
            out.append("%.16f %.16f %.16f" % (v[0], v[1], v[2])
                       + (" %.16f" * len(c)) % tuple(c) + "\n")
    if face_color is None:
        for f in faces:
            out.append("3 %d %d %d\n" % (f[0], f[1], f[2]))
    else:
        for f, c in zip(faces, _np(face_color)):
            out.append("3 %d %d %d\n" % (f[0], f[1], f[2])
                       + (" %.16f" * len(c)) % tuple(c) + "\n")
    with open(file_name, "w") as fl:
        fl.write("".join(out))


def save_goff(file_name, points, sigmas, radians=None):
    """Save a GOFF Gaussian scene (reference ``IO.py:129-163``)."""
    if isinstance(sigmas, tuple):
        sigmas = np.concatenate([_np(s) for s in sigmas], axis=1)
    points, sigmas = _np(points), _np(sigmas)
    if radians is not None:
        radians = _np(radians)
    if sigmas.ndim > 2:
        sigmas = sigmas.reshape((sigmas.shape[0], -1))
    if sigmas.ndim == 1:
        sigmas = sigmas[:, None]

    out = ["GOFF\n"]
    out.append("%d %d %d\n" % (points.shape[0], sigmas.shape[1], 0 if radians is None else 1))
    for v in points:
        out.append((("%.16f " * v.size) % tuple(v))[0:-2] + "\n")
    for v in sigmas:
        out.append((("%.16f " * v.size) % tuple(v))[0:-2] + "\n")
    if radians is not None:
        for v in radians:
            out.append("%.16f\n" % v)
    with open(file_name, "w") as fl:
        fl.write("".join(out))


def to_torch(*args, device=None):
    """Arrays -> float32 tensors on ``device`` (None passes through), the
    counterpart of ``voge_tpu``'s ``to_jax`` and the reference's ``to_torch``
    (``IO.py:166``).  ``device=None``: the device of a tensor among the
    arguments, else the card (``_device.resolve_device``); pass
    ``device="cpu"`` for the CPU."""
    device = resolve_device(device, *args)
    return [None if t is None else torch.as_tensor(t, dtype=torch.float32, device=device)
            for t in args]


def pre_process_pascal(verts, *args):
    """PASCAL axis swap (reference ``IO.py:170-175``)."""
    verts = _np(verts)
    verts = np.concatenate((verts[:, 0:1], verts[:, 2:3], -verts[:, 1:2]), axis=1)
    return (verts,) + args
