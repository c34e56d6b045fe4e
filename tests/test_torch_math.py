"""The port's camera math (renderer_tpu_torch/mathx) against the JAX
package's, on the same float32 inputs. Tolerance: rtol = atol = 1e-6
(float32 products summed in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.mathx import camera as jcam
from renderer_tpu.mathx import transforms as jtr
from renderer_tpu_torch.mathx import camera as tcam
from renderer_tpu_torch.mathx import transforms as ttr

TOL = dict(rtol=1e-6, atol=1e-6)


def cameras():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        out.append(dict(
            position=rng.uniform(-20, 20, 3).astype(np.float32), rotation=q,
            fov_y=np.float32(rng.uniform(0.5, 1.5)), aspect=np.float32(rng.uniform(0.5, 2.5)),
            near=np.float32(rng.uniform(0.05, 1.0)), far=np.float32(rng.uniform(50, 300)),
        ))
    return out


@pytest.mark.parametrize("i", range(4))
def test_camera_matrices_match_jax(i):
    c = cameras()[i]
    want = jcam.camera_matrices(jcam.Camera(**{k: jnp.asarray(v) for k, v in c.items()}))
    got = tcam.camera_matrices(tcam.Camera.create(**c, device="cpu"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(tcam.frustum_planes(got[2]).numpy(),
                               np.asarray(jcam.frustum_planes(want[2])), **TOL)


def test_quaternions_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(ttr.quat_to_mat3(torch.from_numpy(q)).numpy(),
                               np.asarray(jtr.quat_to_mat3(jnp.asarray(q))), **TOL)
    axis, angle = [0.3, -1.0, 0.5], 0.7
    np.testing.assert_allclose(ttr.quat_from_axis_angle(axis, angle, device="cpu").numpy(),
                               np.asarray(jtr.quat_from_axis_angle(jnp.asarray(axis), angle)), **TOL)


def test_orbit_camera_is_the_bench_formula():
    import bench

    for angle in (0.3, 0.59):
        want = bench.make_camera(angle)
        got = tcam.orbit_camera(angle, bench.WIDTH / bench.HEIGHT, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
