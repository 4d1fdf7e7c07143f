"""SE(3) / so(3) / quaternion math for serving and the training loss, in
PyTorch.

Port of `argus_tpu/geom.py` (the group operations, Exp and Log, the SO(3)
left Jacobian and its inverse as matrices, the homogeneous matrix of a
pose, the rotation-matrix-to-quaternion map, random poses, the pose-error
metrics and the host-side Unity <-> MuJoCo converters), with the same
conventions
(pypose's): quaternions are xyzw (scalar last), SE(3) elements are 7-vectors
``[tx, ty, tz, qx, qy, qz, qw]``, se(3) tangents are ``[rho(3), phi(3)]``, and
``se3_exp`` is the full exponential ``t = J_l(phi) @ rho``, ``q = so3_exp(phi)``.

Everything is batched over leading dims and uses Taylor branches below
``|phi|^2 < 1e-6`` selected with `torch.where` on safe denominators, so no
branch ever evaluates 0/0: `torch.where` passes the untaken branch's NaN
gradient on as `jnp.where` does, so the guard sits inside each branch too.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-6


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of xyzw quaternions."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion), xyzw."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4):
    v' = v + 2 qv x (qv x v + qw v)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = torch.linalg.cross(qv, torch.linalg.cross(qv, v, dim=-1) + qw * v, dim=-1)
    return v + 2.0 * t


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that w >= 0."""
    return torch.where(q[..., 3:4] < 0.0, -q, q)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> xyzw unit quaternion:
    q_xyz = phi sin(|phi|/2)/|phi|, q_w = cos(|phi|/2); Taylor near 0."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    half = 0.5 * theta
    sinc_half = torch.where(
        small,
        0.5 - theta_sq / 48.0 + theta_sq * theta_sq / 3840.0,
        torch.sin(half) / theta,
    )
    qw = torch.where(
        small,
        1.0 - theta_sq / 8.0 + theta_sq * theta_sq / 384.0,
        torch.cos(half),
    )
    return torch.cat([phi * sinc_half, qw], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """xyzw unit quaternion -> so(3) rotation vector (angle in (-pi, pi]):
    scale = 2 atan2(n, w) / n, Taylor 2/w (1 - n^2 / (3 w^2)) near n = 0."""
    q = quat_canonical(q)  # w >= 0: the short way around
    qv, qw = q[..., :3], q[..., 3:4]
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < _EPS
    safe_n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    scale = torch.where(
        small,
        2.0 / qw - 2.0 * n_sq / (3.0 * qw**3),
        2.0 * torch.atan2(safe_n, qw) / safe_n,
    )
    return qv * scale


def _jacobian_coeff_AB(phi: torch.Tensor):
    """A = (1 - cos t)/t^2 and B = (t - sin t)/t^3, Taylor near 0, keepdim."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    A = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    B = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (safe_sq * theta)
    )
    return A, B


def _jacobian_coeff_C(phi: torch.Tensor) -> torch.Tensor:
    """C = 1/t^2 - (1 + cos t) / (2 t sin t), Taylor near 0, keepdim; near
    t = pi both (1 + cos t) and sin t vanish and the ratio stays finite."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    sin_t = torch.sin(theta)
    safe_sin = torch.where(sin_t.abs() < 1e-20, torch.full_like(sin_t, 1e-20), sin_t)
    return torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / safe_sq - (1.0 + torch.cos(theta)) / (2.0 * theta * safe_sin),
    )


def so3_left_jacobian_apply(phi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J_l(phi) @ v = v + A (phi x v) + B phi x (phi x v), without the matrix."""
    A, B = _jacobian_coeff_AB(phi)
    pv = torch.linalg.cross(phi, v, dim=-1)
    ppv = torch.linalg.cross(phi, pv, dim=-1)
    return v + A * pv + B * ppv


def so3_left_jacobian_inv_apply(phi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J_l(phi)^-1 @ v = v - 1/2 (phi x v) + C phi x (phi x v), without the matrix."""
    C = _jacobian_coeff_C(phi)
    pv = torch.linalg.cross(phi, v, dim=-1)
    ppv = torch.linalg.cross(phi, pv, dim=-1)
    return v - 0.5 * pv + C * ppv


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1), torch.stack([-y, x, zero], -1)], -2
    )


def _outer_minus_thetasq(phi: torch.Tensor) -> torch.Tensor:
    """[phi]x^2 as outer(phi, phi) - |phi|^2 I, no matmul."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    outer = phi[..., :, None] * phi[..., None, :]
    return outer - theta_sq * torch.eye(3, dtype=phi.dtype, device=phi.device)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3) as a (..., 3, 3) matrix: I + A [phi]x + B [phi]x^2."""
    A, B = _jacobian_coeff_AB(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + A[..., None] * _skew(phi) + B[..., None] * _outer_minus_thetasq(phi)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian as a (..., 3, 3) matrix: I - 1/2 [phi]x + C [phi]x^2."""
    C = _jacobian_coeff_C(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * _skew(phi) + C[..., None] * _outer_minus_thetasq(phi)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """se(3) 6-vector [rho, phi] -> SE(3) 7-vector [t, q_xyzw] (pypose Exp)."""
    rho, phi = tau[..., :3], tau[..., 3:6]
    return torch.cat([so3_left_jacobian_apply(phi, rho), so3_exp(phi)], dim=-1)


def se3_log(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) 7-vector [t, q_xyzw] -> se(3) 6-vector [rho, phi] (pypose Log):
    phi = so3_log(q), rho = J_l(phi)^-1 @ t."""
    phi = so3_log(pose[..., 3:7])
    return torch.cat([so3_left_jacobian_inv_apply(phi, pose[..., :3]), phi], dim=-1)


def se3_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose SE(3) 7-vectors a . b (pypose `a @ b`)."""
    t = a[..., :3] + quat_rotate(a[..., 3:7], b[..., :3])
    return torch.cat([t, quat_multiply(a[..., 3:7], b[..., 3:7])], dim=-1)


def se3_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Inverse of an SE(3) 7-vector (pypose `Inv`)."""
    q_inv = quat_conjugate(pose[..., 3:7])
    return torch.cat([-quat_rotate(q_inv, pose[..., :3]), q_inv], dim=-1)


def se3_matrix(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) 7-vector -> (..., 4, 4) homogeneous matrix (pypose `matrix()`)."""
    x, y, z, w = pose[..., 3:7].unbind(-1)
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
    top = torch.cat([R, pose[..., :3, None]], -1)  # (..., 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], -2)


def random_se3(generator: torch.Generator, shape=(), stdev: float = 1.0) -> torch.Tensor:
    """Random se(3) tangents ~ N(0, stdev), (*shape, 6) f32 on the
    generator's device (pypose `randn_se3`; the draws are torch's, not
    jax.random's)."""
    return stdev * torch.randn(*shape, 6, generator=generator, device=generator.device)


def random_SE3(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Random SE(3) poses, Exp of N(0, 1) tangents (pypose `randn_SE3`)."""
    return se3_exp(random_se3(generator, shape))


def pose_errors(pred: torch.Tensor, target: torch.Tensor) -> tuple:
    """(rotation error in degrees, translation error in metres) between
    (..., 7) xyzw poses, per pose."""
    dq = quat_normalize(quat_multiply(pred[..., 3:], quat_conjugate(target[..., 3:])))
    ang = 2.0 * torch.arccos(torch.clamp(dq[..., 3].abs(), 0.0, 1.0))
    return torch.rad2deg(ang), torch.linalg.norm(pred[..., :3] - target[..., :3], dim=-1)


def xyzwxyz_to_xyzxyzw_SE3(pose):
    """(x,y,z, qw,qx,qy,qz) -> (x,y,z, qx,qy,qz,qw): the HDF5 datasets' wxyz
    order to the model's xyzw, converted once at load. Takes a torch tensor
    or a numpy array and returns the same kind."""
    if isinstance(pose, torch.Tensor):
        return torch.cat([pose[..., :3], pose[..., -3:], pose[..., -4:-3]], dim=-1)
    return np.concatenate([pose[..., :3], pose[..., -3:], pose[..., -4:-3]], axis=-1)


def xyzxyzw_to_xyzwxyz_SE3(pose):
    """(x,y,z, qx,qy,qz,qw) -> (x,y,z, qw,qx,qy,qz), the MuJoCo qpos order.
    Takes a torch tensor or a numpy array and returns the same kind."""
    if isinstance(pose, torch.Tensor):
        return torch.cat([pose[..., :3], pose[..., -1:], pose[..., -4:-1]], dim=-1)
    return np.concatenate([pose[..., :3], pose[..., -1:], pose[..., -4:-1]], axis=-1)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> xyzw unit quaternions, w >= 0
    (branchless Shepperd, argus_tpu's `matrix_to_quat`): all four candidate
    quaternions, one per dominant diagonal or trace case, and the one with
    the largest 4 q_k^2 picked with `torch.where`."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def half_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) / 2.0

    w_w = half_sqrt(qw2)
    cand_w = torch.stack([(m21 - m12) / (4 * w_w), (m02 - m20) / (4 * w_w), (m10 - m01) / (4 * w_w), w_w], -1)
    x_x = half_sqrt(qx2)
    cand_x = torch.stack([x_x, (m01 + m10) / (4 * x_x), (m02 + m20) / (4 * x_x), (m21 - m12) / (4 * x_x)], -1)
    y_y = half_sqrt(qy2)
    cand_y = torch.stack([(m01 + m10) / (4 * y_y), y_y, (m12 + m21) / (4 * y_y), (m02 - m20) / (4 * y_y)], -1)
    z_z = half_sqrt(qz2)
    cand_z = torch.stack([(m02 + m20) / (4 * z_z), (m12 + m21) / (4 * z_z), z_z, (m10 - m01) / (4 * z_z)], -1)
    best = torch.argmax(torch.stack([qx2, qy2, qz2, qw2], -1), dim=-1)[..., None]
    q = torch.where(best == 3, cand_w, torch.where(best == 0, cand_x, torch.where(best == 1, cand_y, cand_z)))
    return quat_canonical(quat_normalize(q))


def convert_pose_mjpc_to_unity(pose_mjpc: np.ndarray) -> np.ndarray:
    """MuJoCo pose (..., 7) wxyz -> Unity pose (..., 7) xyzw, in numpy: the
    inverse of `convert_pose_unity_to_mjpc`, w >= 0."""
    R_m2u = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    trans_unity = (R_m2u @ pose_mjpc[..., :3, None]).squeeze(-1)
    q_wxyz = pose_mjpc[..., 3:]
    q_xyzw = np.concatenate([q_wxyz[..., 1:], q_wxyz[..., :1]], axis=-1)
    quat_unity = np.concatenate(
        [-q_xyzw[..., 1:2], q_xyzw[..., 2:3], q_xyzw[..., 0:1], -q_xyzw[..., 3:4]], axis=-1
    )
    neg_w = quat_unity[..., 3] < 0
    quat_unity[neg_w] = -quat_unity[neg_w]
    return np.concatenate([trans_unity, quat_unity], axis=-1)


def convert_pose_unity_to_mjpc(pose_unity: np.ndarray) -> np.ndarray:
    """Unity pose (..., 7) xyzw -> MuJoCo pose (..., 7) wxyz, in numpy:
    the axis remap of the translation, and the quaternion's matching remap
    with the angle's sign flipped (left- to right-handed), w >= 0."""
    R_u2m = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    trans_mjpc = (R_u2m @ pose_unity[..., :3, None]).squeeze(-1)
    q_xyzw = pose_unity[..., 3:]
    q_wxyz = np.concatenate([q_xyzw[..., -1:], q_xyzw[..., :-1]], axis=-1)
    quat_mjpc = np.concatenate(
        [-q_wxyz[..., 0:1], q_wxyz[..., 3:4], -q_wxyz[..., 1:2], q_wxyz[..., 2:3]], axis=-1
    )
    neg_w = quat_mjpc[..., 0] < 0
    quat_mjpc[neg_w] = -quat_mjpc[neg_w]
    return np.concatenate([trans_mjpc, quat_mjpc], axis=-1)


def convert_unity_quat_to_euler(quat: np.ndarray) -> np.ndarray:
    """Unity xyzw quaternion -> intrinsic XYZ Euler angles in degrees (a
    debugging aid against the Unity inspector; scipy, imported here)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(quat).as_euler("XYZ", degrees=True)
