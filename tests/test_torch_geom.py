"""The port's geometry (`argus_tpu_torch.geom`) against argus_tpu's on the
same inputs, made from a seed with numpy: the SO(3) left Jacobian and its
inverse as matrices (their small-angle branches included), the skew and
[phi]x^2 matrices, the homogeneous matrix of a pose, the pose errors and
the host-side converters. Tolerance 1e-5 absolute on f32 values of order 1
(the two sides order their f32 sums alike; a few ulps apart at most).
`random_se3` / `random_SE3` draw torch's numbers, not jax.random's: they
are held to their distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu import geom as jg
from argus_tpu_torch import geom as tg

ATOL = 1e-5


def _phis():
    """Rotation vectors of every size: ordinary, within the Taylor branch
    (|phi|^2 < 1e-6), at its edge, exactly zero, and near pi."""
    rng = np.random.default_rng(0)
    big = rng.normal(size=(16, 3))
    small = rng.normal(size=(8, 3)) * 1e-4
    edge = rng.normal(size=(4, 3))
    edge *= (1e-3 * np.array([0.999, 1.001, 0.9999, 1.0001]))[:, None] / np.linalg.norm(edge, axis=1, keepdims=True)
    near_pi = rng.normal(size=(4, 3))
    near_pi *= (np.pi - 1e-3) / np.linalg.norm(near_pi, axis=1, keepdims=True)
    return np.concatenate([big, small, edge, np.zeros((2, 3)), near_pi]).astype(np.float32)


def _poses(n=16, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)), q], axis=1).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["_skew", "_outer_minus_thetasq", "so3_left_jacobian", "so3_left_jacobian_inv"])
def test_so3_matrices_match_argus_tpu(name):
    phi = _phis()
    _close(getattr(tg, name)(torch.from_numpy(phi)), getattr(jg, name)(jnp.asarray(phi)))


def test_left_jacobian_inverse_is_inverse():
    phi = torch.from_numpy(_phis()[:-4])  # away from pi, where J_l is singular
    prod = tg.so3_left_jacobian(phi) @ tg.so3_left_jacobian_inv(phi)
    _close(prod, np.broadcast_to(np.eye(3, dtype=np.float32), prod.shape), atol=1e-4)


def test_se3_matrix_and_pose_errors_match_argus_tpu():
    a, b = _poses(seed=1), _poses(seed=2)
    _close(tg.se3_matrix(torch.from_numpy(a)), jg.se3_matrix(jnp.asarray(a)))
    got, want = tg.pose_errors(torch.from_numpy(a), torch.from_numpy(b)), jg.pose_errors(jnp.asarray(a),
                                                                                        jnp.asarray(b))
    _close(got[0], want[0], atol=1e-4)  # degrees of order 100: an f32 ulp there is 7.6e-6
    _close(got[1], want[1])
    # a pose against itself: zero error
    same = tg.pose_errors(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same[1].abs().max()) == 0.0 and float(same[0].max()) < 0.05  # arccos of 1 - ulp: 0.03 deg


def test_host_converters_match_argus_tpu():
    pose = _poses(seed=3).astype(np.float64)
    wxyz = np.concatenate([pose[:, :3], pose[:, 6:7], pose[:, 3:6]], axis=1)
    np.testing.assert_allclose(tg.convert_pose_mjpc_to_unity(wxyz.copy()),
                               jg.convert_pose_mjpc_to_unity(wxyz.copy()), atol=1e-12, rtol=0)
    # the two converters are each other's inverse (w >= 0 on both sides)
    back = tg.convert_pose_unity_to_mjpc(tg.convert_pose_mjpc_to_unity(wxyz.copy()))
    flip = np.where(wxyz[:, 3:4] < 0, -1.0, 1.0)
    np.testing.assert_allclose(back[:, :3], wxyz[:, :3], atol=1e-12)
    np.testing.assert_allclose(back[:, 3:], flip * wxyz[:, 3:], atol=1e-12)
    quat = pose[:, 3:]
    np.testing.assert_allclose(tg.convert_unity_quat_to_euler(quat), jg.convert_unity_quat_to_euler(quat),
                               atol=1e-9, rtol=0)


@pytest.mark.parametrize("stdev", [1.0, 0.25])
def test_random_se3_distribution(stdev):
    """(*shape, 6) f32 draws of N(0, stdev): the sample stdev within 5
    standard errors (n = 4096 x 6 draws: se ~ stdev / sqrt(2 n)), the mean
    within 5 of its own, and a generator's seed repeats them."""
    g = torch.Generator().manual_seed(0)
    x = tg.random_se3(g, (64, 64), stdev=stdev)
    assert x.shape == (64, 64, 6) and x.dtype == torch.float32
    n = x.numel()
    assert abs(float(x.std()) - stdev) < 5 * stdev / np.sqrt(2 * n)
    assert abs(float(x.mean())) < 5 * stdev / np.sqrt(n)
    again = tg.random_se3(torch.Generator().manual_seed(0), (64, 64), stdev=stdev)
    assert torch.equal(x, again)


def test_random_SE3_is_exp_of_random_se3():
    poses = tg.random_SE3(torch.Generator().manual_seed(3), (32,))
    assert poses.shape == (32, 7) and poses.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(poses[:, 3:], dim=-1).numpy(), 1.0, atol=1e-6)
    tangents = tg.random_se3(torch.Generator().manual_seed(3), (32,))
    _close(poses, tg.se3_exp(tangents), atol=0)
    # argus_tpu's Exp of the same tangents
    _close(poses, jg.se3_exp(jnp.asarray(tangents.numpy())))
