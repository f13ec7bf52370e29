"""The bfloat16 input contract of ``tests/test_bf16.py``, twinned: every
public entry point accepts ``torch.bfloat16`` inputs, computes in float32 and
returns the dtype that promotion gives (``torch.promote_types``, which here
agrees with JAX's ``result_type``: bfloat16 with float32 is float32); the
renders and images against ``voge_tpu``'s on the same bfloat16 inputs.
Fragments are float32 by contract on both sides, so ``get_silhouette`` is
float32 whatever the inputs were."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter import Cuboid
import voge_tpu.renderer as jr
from voge_tpu.sampler import sample_features as j_sample_features
import voge_tpu_torch as vt

torch.set_num_threads(2)

# voge_tpu's CPU coarse stage truncates bins at max_point_per_bin (default
# 60 here, exceeded at this zoom: reference fault 5); a cap above P keeps
# both sides exact
KW = dict(image_size=(32, 32), max_assign=6, max_point_per_bin=1000)


@pytest.fixture(scope="module")
def scene():
    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 200, percentage=0.6, as_obj=True)
    verts, sigmas = np.asarray(g.verts, np.float32), np.asarray(g.sigmas, np.float32)
    colors = ((verts + 1) / 3).astype(np.float32)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    cam = (np.asarray(R), np.asarray(T), np.array([[40.0, 40.0]], np.float32),
           np.array([[16.0, 16.0]], np.float32))
    frag_j = jr.render_pipeline(jnp.asarray(verts), jnp.asarray(sigmas), *cam, **KW)
    tcam = tuple(torch.tensor(x) for x in cam)
    frag_t = vt.render_pipeline(torch.tensor(verts), torch.tensor(sigmas), *tcam, **KW)
    assert int(frag_j.overflow_points) == 0 == int(frag_t.overflow_points)
    return verts, sigmas, colors, cam, tcam, frag_j, frag_t


def test_render_pipeline_accepts_bf16_geometry(scene):
    verts, sigmas, _, cam, tcam, frag_j32, frag32 = scene
    bf = lambda x: torch.tensor(x).to(torch.bfloat16)
    frag = vt.render_pipeline(bf(verts), bf(sigmas), *tcam, **KW)
    assert frag.vert_weight.dtype == torch.float32 and frag.vert_hit_length.dtype == torch.float32
    assert np.allclose(frag.vert_weight.sum().item(), frag32.vert_weight.sum().item(), rtol=0.05)
    # voge_tpu on the same bfloat16 inputs: the same quantised scene
    frag_j = jr.render_pipeline(jnp.asarray(verts, jnp.bfloat16), jnp.asarray(sigmas, jnp.bfloat16),
                                *cam, **KW)
    agree = (frag.vert_index.numpy() == np.asarray(frag_j.vert_index)).all(-1)
    assert 1.0 - agree.mean() < 1e-3
    np.testing.assert_allclose(frag.vert_weight.numpy()[agree],
                               np.asarray(frag_j.vert_weight)[agree], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_interpolate_attr_promotion(scene, dt):
    _, _, colors, _, _, frag_j, frag32 = scene
    img = vt.interpolate_attr(frag32, torch.tensor(colors).to(dt))
    assert img.dtype == torch.promote_types(dt, torch.float32) == torch.float32
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dt]
    want = jr.interpolate_attr(frag_j, jnp.asarray(colors, jdt))
    assert np.dtype(want.dtype) == np.float32
    ref = vt.interpolate_attr(frag32, torch.tensor(colors))
    assert (img - ref).abs().max().item() < 2e-2
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_get_silhouette_bf16_frag_weights(scene):
    *_, frag_j, frag32 = scene
    sil = vt.get_silhouette(frag32)
    assert sil.dtype == torch.float32
    np.testing.assert_allclose(sil.numpy(), np.asarray(jr.get_silhouette(frag_j)), atol=1e-4)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_sample_features_promotion(scene, dt):
    *_, frag_j, frag32 = scene
    image = torch.ones((1, 32, 32, 3), dtype=dt) * 0.5
    feat, wsum = vt.sample_features(frag32, image, n_vert=200)
    want = torch.promote_types(dt, torch.float32)
    assert feat.dtype == want and wsum.dtype == want
    f32, _ = vt.sample_features(frag32, image.to(torch.float32), n_vert=200)
    assert (feat.to(torch.float32) - f32).abs().max().item() < 2e-2
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dt]
    jfeat, jwsum = j_sample_features(frag_j, jnp.ones((1, 32, 32, 3), jdt) * 0.5, n_vert=200)
    assert np.dtype(jfeat.dtype) == np.float32
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=0, atol=1e-4)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jwsum), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_to_white_background_promotion(scene, dt):
    _, _, colors, _, _, frag_j, frag32 = scene
    img = vt.to_white_background(frag32, torch.tensor(colors).to(dt))
    assert img.dtype == torch.promote_types(dt, torch.float32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dt]
    want = jr.to_white_background(frag_j, jnp.asarray(colors, jdt))
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=0, atol=1e-4)
