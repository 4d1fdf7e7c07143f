"""Synthetic dataset writer: the test suite's fixture recipe as a library
utility, a copy of `argus_tpu/data/synthetic.py` (which imports nothing of
JAX but its keypoint geometry: here the port's `cube_corners` and
`nominal_camera_matrices`, as numpy).

Produces a dataset in the datagen writer's schema:

    <dir>/<dir-stem>.hdf5
        attrs: n_cams, W, H
        train/ {cube_poses (N,7) wxyz, q_leap (N,16), img_stems}
        test/  {same}
    <dir>/img/img{i}_{a,b}.png   uint8 RGB

For the same arguments and seed it writes argus_tpu's HDF5 datasets and PNG
pixels. `h5py` and PIL are imported when a dataset is written; the
renderers (`render_dataset_arrays`) need neither.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from argus_tpu_torch.models.keypoint_net import cube_corners, nominal_camera_matrices


def _random_wxyz_poses(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random SE(3) poses as (n, 7) arrays with **wxyz** quats (the HDF5 order)."""
    from scipy.spatial.transform import Rotation as R

    trans = rng.normal(size=(n, 3))
    quat_xyzw = R.random(n, random_state=np.random.RandomState(rng.integers(2**31))).as_quat()
    quat_wxyz = np.concatenate([quat_xyzw[:, 3:], quat_xyzw[:, :3]], axis=-1)
    return np.concatenate([trans, quat_wxyz], axis=-1)


def _render_pose_encoded(pose_wxyz: np.ndarray, height: int, width: int, cam: int) -> np.ndarray:
    """Render an image whose content is a FUNCTION of the pose: a colored square
    whose position encodes (x, y) and whose size encodes z, viewed with a
    per-camera parallax shift. A regressor can learn the translation from these —
    used to demonstrate end-to-end learning without Unity."""
    img = np.full((height, width, 3), 40, np.uint8)
    x, y, z = np.tanh(pose_wxyz[:3])
    cx = int((0.5 + 0.3 * x + 0.05 * (cam - 0.5)) * width)
    cy = int((0.5 + 0.3 * y) * height)
    half = max(4, int((0.08 + 0.05 * (z + 1) / 2) * min(height, width)))
    color = np.array([200, 120 + int(50 * x), 80 + int(50 * y)], np.uint8)
    y0, y1 = max(0, cy - half), min(height, cy + half)
    x0, x1 = max(0, cx - half), min(width, cx + half)
    img[y0:y1, x0:x1] = color
    return img


def _workspace_wxyz_poses(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random poses INSIDE the rig workspace (cube near the grasp point, fully
    random orientation) — every corner projects into both cameras."""
    from scipy.spatial.transform import Rotation as R

    trans = np.array([0.0, 0.0, 0.05]) + rng.uniform(
        [-0.04, -0.04, -0.03], [0.04, 0.04, 0.03], size=(n, 3)
    )
    quat_xyzw = R.random(n, random_state=np.random.RandomState(rng.integers(2**31))).as_quat()
    quat_wxyz = np.concatenate([quat_xyzw[:, 3:], quat_xyzw[:, :3]], axis=-1)
    return np.concatenate([trans, quat_wxyz], axis=-1)


# 8 visually distinct corner colors (order = models.keypoint_net.cube_corners)
_CORNER_COLORS = np.array(
    [
        [230, 60, 60], [60, 200, 80], [70, 120, 240], [240, 200, 50],
        [230, 120, 40], [170, 70, 220], [70, 220, 210], [235, 235, 235],
    ],
    np.uint8,
)


def _face_table() -> list:
    """The cube's 6 faces as (axis, sign, quad corner indices).

    Corner indexing matches models.keypoint_net.cube_corners (sign-lexicographic:
    idx = 4*(sx>0) + 2*(sy>0) + (sz>0)). The quad lists each face's 4 corners in
    texture order — (s, t) = (0,0), (1,0), (1,1), (0,1) — with s following the
    first non-face axis and t the second, so every face carries a well-defined
    2D texture frame."""
    faces = []
    for axis in range(3):
        for g in (-1, 1):
            others = [a for a in range(3) if a != axis]
            quad = []
            for sb, sc in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                s = [0, 0, 0]
                s[axis] = g
                s[others[0]] = sb
                s[others[1]] = sc
                quad.append(((s[0] > 0) << 2) | ((s[1] > 0) << 1) | (s[2] > 0))
            faces.append((axis, g, quad))
    return faces


_CUBE_FACES = _face_table()  # face ids 0..5 = -x, +x, -y, +y, -z, +z


def _face_pattern(face_id: int, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Per-face LUMINANCE pattern over texture coords (s, t) in [0,1]^2 -> [0,1].

    Six visually distinct patterns — stripes at three orientations, a checker,
    a disc, a diagonal split — i.e. the glyph/texture cue family of the
    real cube's per-face textures. Pattern identity per face pins the full
    rotation (3 visible face identities = an orthonormal frame); the inverted
    corner patch additionally breaks each pattern's own 180-degree symmetry.

    These are LUMINANCE cues: hue/saturation/planckian jitter — the
    photometric stack that erases the corner-dot COLOR identity signal —
    cannot remove them, and the
    4-period stripe pitch (~15-25 px at rendered face sizes) survives the
    gaussian/motion blur ranges of ops/augment.py."""
    if face_id == 0:
        p = np.floor(t * 4) % 2
    elif face_id == 1:
        p = np.floor(s * 4) % 2
    elif face_id == 2:
        p = np.floor((s + t) * 4) % 2
    elif face_id == 3:
        p = (np.floor(s * 3) + np.floor(t * 3)) % 2
    elif face_id == 4:
        p = (((s - 0.5) ** 2 + (t - 0.5) ** 2) < 0.09).astype(np.float32)
    else:
        p = (s > t).astype(np.float32)
    marker = (s < 0.28) & (t < 0.28)
    return np.where(marker, 1.0 - p, p).astype(np.float32)


def _fill_face_quad(img: np.ndarray, quad_uv: np.ndarray, face_id: int, contrast: float) -> None:
    """Rasterize one cube face in-place: solve the unit-square -> projected-quad
    homography, inverse-map the bounding-box pixels to texture coords, and fill
    with the face's grayscale pattern (same value in all 3 channels — pure
    luminance, untouched by hue/saturation augmentation)."""
    h_img, w_img = img.shape[:2]
    src = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, quad_uv)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        b[2 * i] = u
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i + 1] = v
    try:
        H = np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)
        Hinv = np.linalg.inv(H)
    except np.linalg.LinAlgError:
        return  # edge-on (degenerate) face: nothing visible to draw
    u0 = max(0, int(np.floor(quad_uv[:, 0].min())))
    u1 = min(w_img, int(np.ceil(quad_uv[:, 0].max())) + 1)
    v0 = max(0, int(np.floor(quad_uv[:, 1].min())))
    v1 = min(h_img, int(np.ceil(quad_uv[:, 1].max())) + 1)
    if u0 >= u1 or v0 >= v1:
        return
    uu, vv = np.meshgrid(np.arange(u0, u1) + 0.5, np.arange(v0, v1) + 0.5)
    st = Hinv @ np.stack([uu.ravel(), vv.ravel(), np.ones(uu.size)])
    w = np.where(np.abs(st[2]) < 1e-12, 1e-12, st[2])
    s, t = st[0] / w, st[1] / w
    inside = (s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
    if not inside.any():
        return
    # per-face base luminance (identity cue) + pattern contrast around it
    vals = (92.0 + 14.0 * face_id) + contrast * (_face_pattern(face_id, s, t) - 0.5)
    m = inside.reshape(uu.shape)
    img[v0:v1, u0:u1][m] = np.clip(vals, 0, 255).reshape(uu.shape)[m][:, None]


@dataclass(frozen=True)
class RenderStyle:
    """Nuisance-parameter distribution for the corner renderer — the knob that
    makes TRANSFER-shifted accuracy protocols possible: pretrain
    on one rendering distribution, fine-tune on a disjoint one, the synthetic
    analog of the reference's ImageNet-pretrain -> Unity-sim fine-tune
    (reference: argus/models.py:43 pretrained=True; domain randomization knobs
    it shifts: argus/data_generation.py:46-107 camera/light perturbations).

    The pose -> corner-projection TASK (nominal cameras, corner color identity)
    is shared across styles; only nuisance appearance shifts.

    Fields:
        bg_base: background gray value (0-255).
        bg_noise: per-pixel uniform noise amplitude.
        checker: checkerboard tile size in px (0 = flat background).
        checker_contrast: +- value of the checker squares.
        light_gradient: amplitude of a random-direction linear brightness ramp.
        dot_radius_scale: corner-dot radius multiplier.
        cam_jitter_px: per-image Gaussian jitter of the projected uv, in px at
            the render resolution (camera-pose perturbation analog).
        distractors: count of random non-corner gray squares (occluder analog).
        color_jitter: multiplicative corner-color jitter amplitude.
        faces: render the cube's 6 faces with per-face LUMINANCE patterns (the
            analog of the real cube's per-face textures). This is the
            rotation signal that SURVIVES photometric augmentation: the
            corner-dot-only renderer encodes rotation
            solely in dot COLOR identity, which hue/saturation/planckian
            jitter attacks directly. With faces on, the cube is opaque: only
            corners adjacent to a visible face get dots.
        face_contrast: luminance amplitude of the face patterns.
    """

    bg_base: int = 40
    bg_noise: float = 0.0
    checker: int = 0
    checker_contrast: int = 0
    light_gradient: float = 0.0
    dot_radius_scale: float = 1.0
    cam_jitter_px: float = 0.0
    distractors: int = 0
    color_jitter: float = 0.0
    faces: bool = False
    face_contrast: float = 70.0


# Disjoint style pair for the transfer-shifted protocol. Every nuisance knob
# differs: PRETRAIN_STYLE is the "generic webcrawl-ish" distribution (textured,
# noisy, big dots, strong lighting, larger camera jitter, occluders);
# FINETUNE_STYLE is the "target sim" (near-flat dark background, small clean
# dots, mild lighting, small camera jitter, no occluders).
PRETRAIN_STYLE = RenderStyle(
    bg_base=90, bg_noise=25.0, checker=32, checker_contrast=18,
    light_gradient=35.0, dot_radius_scale=1.5, cam_jitter_px=4.0,
    distractors=3, color_jitter=0.18,
)
FINETUNE_STYLE = RenderStyle(
    bg_base=40, bg_noise=4.0, checker=0, checker_contrast=0,
    light_gradient=10.0, dot_radius_scale=1.0, cam_jitter_px=1.0,
    distractors=0, color_jitter=0.05,
)

# Face-textured variants: identical nuisance knobs, plus the opaque
# per-face-patterned cube. The only delta is the added luminance rotation
# signal, so A/B deltas are attributable to it alone.
import dataclasses as _dc

PRETRAIN_STYLE_FACES = _dc.replace(PRETRAIN_STYLE, faces=True)
FINETUNE_STYLE_FACES = _dc.replace(FINETUNE_STYLE, faces=True)


def _styled_background(rng: np.random.Generator, height: int, width: int, style: RenderStyle) -> np.ndarray:
    """(H, W, 3) float32 background drawn from the style's nuisance distribution."""
    img = np.full((height, width, 3), float(style.bg_base), np.float32)
    if style.checker:
        yy, xx = np.mgrid[0:height, 0:width]
        mask = ((yy // style.checker + xx // style.checker) % 2).astype(np.float32)
        img += (mask * 2.0 - 1.0)[..., None] * style.checker_contrast
    if style.light_gradient:
        theta = rng.uniform(0.0, 2.0 * np.pi)
        yy, xx = np.mgrid[0:height, 0:width]
        ramp = (xx / width - 0.5) * np.cos(theta) + (yy / height - 0.5) * np.sin(theta)
        img += 2.0 * style.light_gradient * ramp.astype(np.float32)[..., None]
    if style.bg_noise:
        img += rng.uniform(-style.bg_noise, style.bg_noise, (height, width, 3)).astype(np.float32)
    return img


def _render_corner_projection(
    pose_wxyz: np.ndarray, height: int, width: int, P: np.ndarray = None,
    corners: np.ndarray = None, style: "RenderStyle" = None,
    rng: np.random.Generator = None,
) -> list:
    """Render BOTH cameras' views of the posed cube's 8 corners, projected with the
    rig's nominal camera matrices (models.keypoint_net.nominal_camera_matrices) —
    each corner a distinct colored dot. Full 6-DoF pose is recoverable from the two
    views, so both model families (direct se(3) regression AND corner-keypoint
    triangulation) can learn it.

    Pass `P` (the (2, 3, 4) projection matrices) and `corners` when rendering
    many images, to compute them once."""
    from scipy.spatial.transform import Rotation as R

    if P is None:
        P = nominal_camera_matrices(height, width).numpy()  # (2, 3, 4)
    if corners is None:
        corners = cube_corners().numpy()
    t, q_wxyz = pose_wxyz[:3], pose_wxyz[3:]
    rot = R.from_quat(np.concatenate([q_wxyz[1:], q_wxyz[:1]])).as_matrix()
    pts = corners @ rot.T + t  # (8, 3) world
    r = max(2, min(height, width) // 42)
    if style is not None:
        assert rng is not None, "styled rendering needs an explicit rng"
        r = max(2, int(round(r * style.dot_radius_scale)))
        colors = np.clip(
            _CORNER_COLORS.astype(np.float32)
            * (1.0 + rng.uniform(-style.color_jitter, style.color_jitter, (8, 1))),
            0, 255,
        )
    else:
        colors = _CORNER_COLORS.astype(np.float32)
    imgs = []
    for cam in range(2):
        if style is not None:
            img = _styled_background(rng, height, width, style)
            for _ in range(style.distractors):
                dr = rng.integers(r, 3 * r + 1)
                du = rng.integers(0, width)
                dv = rng.integers(0, height)
                shade = rng.uniform(20, 160)
                img[max(0, dv - dr) : dv + dr, max(0, du - dr) : du + dr] = shade
        else:
            img = np.full((height, width, 3), 40.0, np.float32)
        uvw = np.concatenate([pts, np.ones((8, 1))], axis=1) @ P[cam].T  # (8, 3)
        uv = uvw[:, :2] / uvw[:, 2:3]
        if style is not None and style.cam_jitter_px:
            # one rigid shift per camera view: the camera moved, not the corners
            uv = uv + rng.normal(0.0, style.cam_jitter_px, (1, 2))
        corner_visible = np.ones(8, bool)
        if style is not None and style.faces:
            # opaque textured cube: paint back-face-culled faces (convex, so
            # visible faces never overlap — no z-buffer needed), then dots only
            # on corners adjacent to >=1 visible face (the single fully-hidden
            # corner gets none, like the reference's opaque cube)
            C_cam = -np.linalg.inv(P[cam][:, :3]) @ P[cam][:, 3]  # camera center
            hw_cube = float(np.abs(corners).max())
            corner_visible[:] = False
            for face_id, (axis, g, quad) in enumerate(_CUBE_FACES):
                n_world = rot[:, axis] * g
                center_world = rot[:, axis] * (g * hw_cube) + t
                if float(n_world @ (C_cam - center_world)) > 1e-9:
                    _fill_face_quad(img, uv[quad], face_id, style.face_contrast)
                    corner_visible[quad] = True
        for k in range(8):
            if not corner_visible[k]:
                continue
            u, v = int(round(uv[k, 0])), int(round(uv[k, 1]))
            if -r < u < width + r and -r < v < height + r:
                img[max(0, v - r) : v + r, max(0, u - r) : u + r] = colors[k]
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs


def _render_examples(rng: np.random.Generator, n_total: int, height: int, width: int, pose_encoded,
                     style: RenderStyle = None):
    """The writer's frames, drawn from `rng` in its order: (per example the
    [cam a, cam b] uint8 (H, W, 3) frames, the (n_total, 7) wxyz poses or
    None for noise frames)."""
    if pose_encoded == "corners":
        poses_all = _workspace_wxyz_poses(rng, n_total)
        # the projection matrices and corner layout once; the corner geometry
        # is the one the keypoint loss and triangulation use
        cam_P = nominal_camera_matrices(height, width).numpy()
        corners = cube_corners().numpy()
    elif pose_encoded:
        poses_all = _random_wxyz_poses(rng, n_total)
    else:
        poses_all = None
    frames = []
    for i in range(n_total):
        if pose_encoded == "corners":
            frames.append(_render_corner_projection(poses_all[i], height, width, cam_P, corners, style=style,
                                                    rng=rng))
        elif pose_encoded:
            frames.append([_render_pose_encoded(poses_all[i], height, width, cam) for cam in range(2)])
        else:
            frames.append([(rng.random((height, width, 3)) * 255).astype(np.uint8) for _ in range(2)])
    return frames, poses_all


def render_dataset_arrays(n: int, height: int = 256, width: int = 256, seed: int = 0, pose_encoded="corners",
                          style: RenderStyle = None) -> tuple:
    """The frames and poses `write_synthetic_dataset(..., n_train=n,
    n_test=0)` writes, as arrays, without h5py, PIL or files: (uint8 (n, H,
    W, 6) with the two cameras concatenated along channels, float32 (n, 7)
    wxyz poses)."""
    rng = np.random.default_rng(seed)
    frames, poses = _render_examples(rng, n, height, width, pose_encoded, style)
    if poses is None:
        poses = _random_wxyz_poses(rng, n)
    return np.stack([np.concatenate(f, axis=-1) for f in frames]), poses.astype(np.float32)


def write_synthetic_dataset(
    out_dir: str,
    n_train: int = 10,
    n_test: int = 5,
    height: int = 256,
    width: int = 256,
    n_cams: int = 2,
    seed: int = 0,
    q_leap_dim: int = 16,
    pose_encoded=False,
    style: RenderStyle = None,
) -> str:
    """Write a complete synthetic dataset to `out_dir`. Returns `out_dir`.

    pose_encoded selects the image content:
      * False — random noise (schema/fixture tests);
      * True — brightness/position square encoding translation (learnable
        translation signal, end-to-end learning demo);
      * "corners" — the 8 cube corners projected through the rig's nominal camera
        matrices into both views (full 6-DoF learnable; the accuracy proxy).

    `style` (corners mode only) draws every image's nuisance appearance from a
    RenderStyle — the lever for transfer-shifted protocols (PRETRAIN_STYLE vs
    FINETUNE_STYLE are disjoint in every nuisance knob).
    """
    import h5py
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = Path(out_dir)
    img_dir = out / "img"
    os.makedirs(img_dir, exist_ok=True)

    frames, poses_all = _render_examples(rng, n_train + n_test, height, width, pose_encoded, style)
    for i, pair in enumerate(frames):
        for arr, suffix in zip(pair, ("a", "b")):
            Image.fromarray(arr).save(img_dir / f"img{i}_{suffix}.png")

    with h5py.File(out / f"{out.stem}.hdf5", "w") as f:
        f.attrs["n_cams"] = n_cams
        f.attrs["W"] = width
        f.attrs["H"] = height
        for name, n, start in (("train", n_train, 0), ("test", n_test, n_train)):
            g = f.create_group(name)
            poses = (
                poses_all[start : start + n]
                if pose_encoded
                else _random_wxyz_poses(rng, n)
            )
            g.create_dataset("cube_poses", data=poses)
            g.create_dataset("q_leap", data=rng.normal(size=(n, q_leap_dim)))
            stems = [f"img/img{i}".encode() for i in range(start, start + n)]
            g.create_dataset("img_stems", data=np.array(stems))

    return str(out)
