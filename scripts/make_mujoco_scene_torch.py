"""Generate the MuJoCo validation scene (mujoco/leap/task.xml) and the cube
textures: the twin of `scripts/make_mujoco_scene.py`, on `argus_tpu_torch`.

It takes the repository root, the nominal camera poses and the Unity-to-MuJoCo
pose conversion from the port (`argus_tpu_torch`, `.datagen`, `.geom`), so a
user of the port regenerates the scene that `validate_real` renders without
JAX. What it writes is byte for byte what the original writes: the same
articulated 16-DoF LEAP right hand (the robot's kinematic constants below are
a copy of the original's, digit for digit: body tree, joint axes and ranges,
actuator gains, collision boxes, the "home" keyframe), the free textured cube
(qpos[:7]), the "goal" mocap body, and the cameras `cam1`/`cam2` at the Unity
nominal poses. The generated file's header names the original, which writes
the same bytes.

When a LEAP rig model is found at `third_party/leap_hand.xml` in the checkout
(`REF_HAND_XML_CANDIDATES`), its visual meshes
are read from the loaded MuJoCo model and written out as OBJ files under
`mujoco/assets/leap_meshes/`, and the scene shows them with the boxes kept for
collision only; otherwise the scene is meshless.

    python scripts/make_mujoco_scene_torch.py

Needs `mujoco` (the mesh path only) and `imageio`; runs on the host, no card.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from argus_tpu_torch import ROOT  # noqa: E402
from argus_tpu_torch.datagen import CAM1_NOMINAL, CAM2_NOMINAL  # noqa: E402
from argus_tpu_torch.geom import convert_pose_unity_to_mjpc  # noqa: E402


# ───────────────────────── LEAP hand kinematic spec ─────────────────────────
# Numeric constants extracted from the reference model (mujoco/leap/leap_hand.xml,
# loaded and read back via mujoco: body_pos/body_quat/jnt_range/geom_size) — the
# physical robot's dimensions, i.e. behavioral contract, not code.

# the three identical fingers: (suffix, mcp body pos in palm frame)
FINGERS = [
    ("", (0.0187, 0.061, 0.091), ("1", "0", "2", "3")),
    ("_2", (0.0187, 0.0156, 0.0909), ("5", "4", "6", "7")),
    ("_3", (0.0187, -0.0298, 0.0909), ("9", "8", "10", "11")),
]
# per-link (pos-in-parent, quat wxyz) for the finger chain below the mcp body
FINGER_CHAIN = {
    "mcp": (None, (0.7071, 0.7071, 0.0, 0.0)),
    "pip": ((-0.0122, 0.0381, 0.0145), (0.5, -0.5, -0.5, 0.5)),
    "dip": ((0.015, 0.0143, -0.013), (0.5, 0.5, -0.5, 0.5)),
    "fingertip": ((0.0, -0.0361, 0.0002), (1.0, 0.0, 0.0, 0.0)),
}
JOINT_RANGES = {
    "mcp": (-0.314, 2.23),
    "pip": (-1.047, 1.047),
    "dip": (-0.506, 1.885),
    "fingertip": (-0.366, 2.042),
    "12": (-0.349, 2.094),
    "13": (-0.47, 2.443),
    "14": (-1.2, 1.9),
    "15": (-1.34, 1.88),
}
# box geoms (size, pos, quat-or-None) per link, black unless marked white
PALM_BOXES = [
    ((0.011, 0.013, 0.017), (0.011, 0.046, 0.089), (0.7071, 0, -0.7071, 0)),
    ((0.011, 0.013, 0.017), (0.011, 0.001, 0.089), (0.7071, 0, -0.7071, 0)),
    ((0.011, 0.013, 0.017), (0.011, -0.044, 0.089), (0.7071, 0, -0.7071, 0)),
    ((0.029, 0.01, 0.023), (0.0115, -0.04, 0.032), (0.6993, 0.1045, -0.6993, -0.1045)),
    ((0.005, 0.06, 0.01), (0.024, 0.003, 0.066), (0.9238, 0, -0.3829, 0)),
    ((0.012, 0.058, 0.023), (0.0115, 0.005, 0.05), (0.7071, 0, -0.7071, 0)),
    ((0.022, 0.026, 0.023), (0.0115, -0.015, 0.02), (0.7071, 0, -0.7071, 0)),
]
LINK_BOXES = {
    "mcp": [
        ((0.01, 0.008, 0.017), (0.0, 0.013, 0.0147), None),
        ((0.014, 0.02, 0.01), (-0.027, 0.042, 0.015), None),
    ],
    "pip": [((0.017, 0.013, 0.011), (0.0075, -0.0002, -0.011), None)],
    "dip": [
        ((0.01, 0.008, 0.017), (0.0, -0.015, 0.0145), None),
        ((0.017, 0.011, 0.013), (0.0075, -0.035, 0.015), None),
    ],
    "fingertip": [((0.01, 0.005, 0.017), (0.0, -0.012, 0.0145), None)],
}
# white distal pads: AABB of the reference's white_tip meshes in the tip body frame
TIP_WHITE = ((0.0105, 0.0150, 0.0121), (-0.00085, -0.03455, 0.0145), None)
THUMB = [
    # (body name, pos-in-parent, quat, joint name, boxes)
    ("pip_4", (0.0216, 0.0368, 0.0287), (1, 0, 0, 0), "12",
     [((0.017, 0.013, 0.011), (-0.0075, -0.0002, -0.011), None)]),
    ("thumb_pip", (0.0, 0.0143, -0.013), (0.5, 0.5, -0.5, 0.5), "13",
     [((0.009, 0.0165, 0.009), (0.0, 0.0, -0.009), None)]),
    ("thumb_dip", (0.0, 0.0145, -0.017), (0.7071, -0.7071, 0, 0), "14",
     [((0.01, 0.02, 0.012), (0.0, 0.0105, -0.014), None),
      ((0.01, 0.01, 0.016), (0.0, 0.041, -0.015), None)]),
    ("thumb_fingertip", (0.0, 0.0466, 0.0002), (0, 0, 0, 1), "15",
     [((0.01, 0.018, 0.012), (0.0, -0.0085, -0.015), None),
      ((0.01, 0.002, 0.015), (0.0, -0.029, -0.014), None)]),
]
THUMB_TIP_WHITE = ((0.0103, 0.0151, 0.0121), (-0.00095, -0.04655, -0.0145), None)
MOUNT_POS = (0.0, 0.0, 0.00635)
PALM_POS = (0.032, 0.007, -0.0335)
PALM_QUAT = (0.0, 0.8192, 0.0, 0.5735)
# the reference's "home" keyframe: cube resting in the hand (task.xml keyframe)
HOME_QPOS = (
    "0.1 0.025 0.035 1 0 0 0 "
    "0.5 -0.75 0.75 0.25 0.5 0 0.75 0.25 0.5 0.75 0.75 0.25 0.65 0.9 0.75 0.6"
)


def _fmt(v) -> str:
    return " ".join(f"{x:g}" for x in v)


# ─────────────────────────── rig mesh conversion ───────────────────────────
# Mesh visuals, when a LEAP rig model is available inside the checkout (the
# reference project's mujoco/leap/leap_hand.xml, or any dex-urdf-derived MJCF,
# placed at third_party/leap_hand.xml): the model is loaded with MuJoCo, its
# processed vertex and face buffers are read from mjModel and written with this
# script's own OBJ writer, so validate_real renders the rig's silhouette. No
# mesh file is copied; with no source model the scene keeps the self-contained
# meshless boxes. Nothing outside the checkout is read.

REF_HAND_XML_CANDIDATES = (
    os.path.join(ROOT, "third_party", "leap_hand.xml"),
)


def extract_hand_meshes(ref_xml: str, mesh_dir: str):
    """Convert the rig's visual meshes via the loaded-model path.

    Returns (mesh_names, {body_name: [(mesh_name, pos, quat, material), ...]}).
    mjModel stores each mesh's POST-compilation vertex data, and geom_pos/quat
    are baked against that frame — so re-emitting the processed buffers plus the
    model-read placements reproduces the visuals exactly, independent of the
    source file format.
    """
    import mujoco

    m = mujoco.MjModel.from_xml_path(ref_xml)
    os.makedirs(mesh_dir, exist_ok=True)
    names = []
    for i in range(m.nmesh):
        name = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_MESH, i)
        va, vn = int(m.mesh_vertadr[i]), int(m.mesh_vertnum[i])
        fa, fn = int(m.mesh_faceadr[i]), int(m.mesh_facenum[i])
        verts = m.mesh_vert[va : va + vn]
        faces = m.mesh_face[fa : fa + fn]
        with open(os.path.join(mesh_dir, f"{name}.obj"), "w") as f:
            f.write("# re-emitted from the loaded rig model by make_mujoco_scene.py\n")
            for v in verts:
                f.write(f"v {v[0]:.5g} {v[1]:.5g} {v[2]:.5g}\n")
            for fc in faces:
                f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")
        names.append(name)
    geoms = {}
    seen = set()
    for g in range(m.ngeom):
        if m.geom_type[g] != mujoco.mjtGeom.mjGEOM_MESH or m.geom_group[g] != 2:
            continue
        body = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, m.geom_bodyid[g])
        mesh = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_MESH, m.geom_dataid[g])
        key = (body, mesh)
        if key in seen:  # the source model duplicates white tips across groups
            continue
        seen.add(key)
        mat = "hand_white" if mesh.startswith("white_tip") else "hand_black"
        geoms.setdefault(body, []).append(
            (mesh, tuple(m.geom_pos[g]), tuple(m.geom_quat[g]), mat)
        )
    return names, geoms


def _mesh_geoms_xml(body: str, mesh_geoms, indent: int) -> str:
    """Visual mesh geom lines for `body` ('' when no meshes are available)."""
    if not mesh_geoms or body not in mesh_geoms:
        return ""
    pad = " " * indent
    lines = [
        f'{pad}<geom type="mesh" mesh="{mesh}" pos="{_fmt(pos)}" quat="{_fmt(quat)}"'
        f' material="{mat}" contype="0" conaffinity="0" density="0" group="2"/>'
        for mesh, pos, quat, mat in mesh_geoms[body]
    ]
    return "\n" + "\n".join(lines)


def _geom(size, pos, quat, material="hand_black", indent=10, group=None) -> str:
    q = f' quat="{_fmt(quat)}"' if quat is not None else ""
    grp = f' group="{group}"' if group is not None else ""
    return (
        " " * indent
        + f'<geom type="box" size="{_fmt(size)}" pos="{_fmt(pos)}"{q} material="{material}"{grp}/>'
    )


def _finger_xml(suffix: str, mcp_pos, joints, base_indent: int, mesh_geoms=None) -> str:
    """One finger chain: mcp -> pip -> dip -> fingertip."""
    box_group = 3 if mesh_geoms else None  # meshes visible, boxes collision-only
    lines = []
    ind = base_indent
    chain = ["mcp", "pip", "dip", "fingertip"]
    body_names = {
        "mcp": f"mcp_joint{suffix}",
        "pip": f"pip{suffix}",
        "dip": f"dip{suffix}",
        "fingertip": f"fingertip{suffix}",
    }
    for li, link in enumerate(chain):
        pos = mcp_pos if link == "mcp" else FINGER_CHAIN[link][0]
        quat = FINGER_CHAIN[link][1]
        lo, hi = JOINT_RANGES[link]
        pad = " " * ind
        lines.append(f'{pad}<body name="{body_names[link]}" pos="{_fmt(pos)}" quat="{_fmt(quat)}">')
        lines.append(
            f'{pad}  <joint name="{joints[li]}" axis="0 0 -1" range="{lo:g} {hi:g}"/>'
        )
        for size, gpos, gquat in LINK_BOXES[link]:
            lines.append(_geom(size, gpos, gquat, indent=ind + 2, group=box_group))
        if link == "fingertip":
            size, gpos, gquat = TIP_WHITE
            lines.append(
                _geom(size, gpos, gquat, material="hand_white", indent=ind + 2, group=box_group)
            )
        mg = _mesh_geoms_xml(body_names[link], mesh_geoms, ind + 2)
        if mg:
            lines.append(mg.lstrip("\n"))
        ind += 2
    for _ in chain:
        ind -= 2
        lines.append(" " * ind + "</body>")
    return "\n".join(lines)


def _thumb_xml(base_indent: int, mesh_geoms=None) -> str:
    box_group = 3 if mesh_geoms else None
    lines = []
    ind = base_indent
    for name, pos, quat, joint, boxes in THUMB:
        lo, hi = JOINT_RANGES[joint]
        pad = " " * ind
        lines.append(f'{pad}<body name="{name}" pos="{_fmt(pos)}" quat="{_fmt(quat)}">')
        lines.append(f'{pad}  <joint name="{joint}" axis="0 0 -1" range="{lo:g} {hi:g}"/>')
        for size, gpos, gquat in boxes:
            lines.append(_geom(size, gpos, gquat, indent=ind + 2, group=box_group))
        if name == "thumb_fingertip":
            size, gpos, gquat = THUMB_TIP_WHITE
            lines.append(
                _geom(size, gpos, gquat, material="hand_white", indent=ind + 2, group=box_group)
            )
        mg = _mesh_geoms_xml(name, mesh_geoms, ind + 2)
        if mg:
            lines.append(mg.lstrip("\n"))
        ind += 2
    for _ in THUMB:
        ind -= 2
        lines.append(" " * ind + "</body>")
    return "\n".join(lines)


def leap_hand_xml(mesh_geoms=None) -> tuple:
    """The articulated LEAP hand worldbody subtree + its actuators. With
    `mesh_geoms` (from extract_hand_meshes) the visuals are the converted rig
    meshes and the boxes become collision-only (group 3); else meshless boxes."""
    bg = 3 if mesh_geoms else None
    fingers = "\n".join(
        _finger_xml(sfx, pos, joints, 8, mesh_geoms) for sfx, pos, joints in FINGERS
    )
    thumb = _thumb_xml(8, mesh_geoms)
    palm_geoms = "\n".join(_geom(s, p, q, group=bg) for s, p, q in PALM_BOXES)
    mount_mesh = _mesh_geoms_xml("mount", mesh_geoms, 6)
    palm_mesh = _mesh_geoms_xml("palm", mesh_geoms, 8)
    mount_box_grp = f' group="{bg}"' if bg else ""
    body = f"""    <body name="mount" pos="{_fmt(MOUNT_POS)}">
      <geom type="box" size="0.035 0.035 0.003" pos="0 0 0" material="hand_black"{mount_box_grp}/>{mount_mesh}
      <body name="palm" pos="{_fmt(PALM_POS)}" quat="{_fmt(PALM_QUAT)}">
        <site name="grasp_site" pos="0.07 0.0 0.1" group="4"/>
{palm_geoms}{palm_mesh}
{fingers}
{thumb}
      </body>
    </body>"""
    # actuator order = the reference's (tree order; names match joint names)
    act_order = [j for _, _, joints in FINGERS for j in joints] + ["12", "13", "14", "15"]
    link_for = {}
    for _, _, joints in FINGERS:
        for j, link in zip(joints, ("mcp", "pip", "dip", "fingertip")):
            link_for[j] = link
    for j in ("12", "13", "14", "15"):
        link_for[j] = j
    acts = "\n".join(
        f'    <position name="{j}" joint="{j}" kp="0.25" kv="0.005" '
        f'ctrlrange="{JOINT_RANGES[link_for[j]][0]:g} {JOINT_RANGES[link_for[j]][1]:g}"/>'
        for j in act_order
    )
    return body, acts


def lookat_xyaxes(pos: np.ndarray, target: np.ndarray) -> str:
    """MJCF camera `xyaxes` for a camera at `pos` looking at `target` (z-up world).

    MuJoCo cameras look along their -z axis; x is image-right, y image-up.
    """
    forward = target - pos
    forward = forward / np.linalg.norm(forward)
    z_cam = -forward
    up = np.array([0.0, 0.0, 1.0])
    x_cam = np.cross(up, z_cam)
    if np.linalg.norm(x_cam) < 1e-8:
        x_cam = np.array([1.0, 0.0, 0.0])
    x_cam = x_cam / np.linalg.norm(x_cam)
    y_cam = np.cross(z_cam, x_cam)
    return " ".join(f"{v:.6f}" for v in np.concatenate([x_cam, y_cam]))


def write_cube_textures(out_dir: str) -> None:
    """Generate 6 distinct 64x64 face textures (solid color + white corner glyph +
    face-index pips) — the orientation-disambiguation role of the reference's
    reorientation_cube_textures, with original generated content."""
    import imageio.v2 as imageio

    colors = [
        (230, 40, 40),    # right  +x red
        (40, 150, 230),   # left   -x blue
        (40, 200, 70),    # front  +y green
        (240, 200, 40),   # back   -y yellow
        (240, 130, 30),   # up     +z orange
        (235, 235, 235),  # down   -z white
    ]
    names = ["right", "left", "front", "back", "up", "down"]
    os.makedirs(out_dir, exist_ok=True)
    for i, (name, rgb) in enumerate(zip(names, colors)):
        img = np.zeros((64, 64, 3), np.uint8)
        img[:] = rgb
        contrast = (0, 0, 0) if name == "down" else (255, 255, 255)
        img[4:18, 4:18] = contrast  # corner glyph breaks face symmetry
        for p in range(i + 1):  # i+1 pips identify the face index
            c0 = 26 + 6 * p
            img[52:58, c0 : c0 + 4] = contrast
        imageio.imwrite(os.path.join(out_dir, f"{name}.png"), img)


def main() -> str:
    # Unity nominals -> MuJoCo frame positions
    cam1 = convert_pose_unity_to_mjpc(CAM1_NOMINAL[None])[0]
    cam2 = convert_pose_unity_to_mjpc(CAM2_NOMINAL[None])[0]
    # frame the grasp: the home keyframe rests the cube in the hand here
    cube_home = np.array([0.1, 0.025, 0.035])

    tex_dir = os.path.join(ROOT, "mujoco", "assets", "cube_faces")
    write_cube_textures(tex_dir)

    # mesh-fidelity hand visuals when a rig model is available (else meshless)
    mesh_names, mesh_geoms = [], None
    mesh_dir = os.path.join(ROOT, "mujoco", "assets", "leap_meshes")
    existing = (
        sorted(n[:-4] for n in os.listdir(mesh_dir) if n.endswith(".obj"))
        if os.path.isdir(mesh_dir)
        else []
    )
    src_xml = next((p for p in REF_HAND_XML_CANDIDATES if os.path.exists(p)), None)
    if src_xml is not None:
        mesh_names, mesh_geoms = extract_hand_meshes(src_xml, mesh_dir)
        print(f"converted {len(mesh_names)} rig meshes from {src_xml} -> {mesh_dir}")
    elif existing:
        # meshes converted earlier, but their placements come only from a
        # source model: without one the scene is regenerated meshless
        print("leap_meshes exist but no source rig model; regenerating meshless scene")
    hand_body, hand_acts = leap_hand_xml(mesh_geoms)
    mesh_assets = "".join(
        f'\n    <mesh name="{n}" file="../assets/leap_meshes/{n}.obj"/>' for n in mesh_names
    )

    xml = f"""<?xml version="1.0" encoding="utf-8"?>
<!-- GENERATED by scripts/make_mujoco_scene.py - do not edit by hand.
     Validation scene: articulated meshless LEAP hand + textured free cube +
     goal body + calibrated cam1/cam2 (capability contract of the reference's
     mujoco/leap/task.xml; kinematic constants from mujoco/leap/leap_hand.xml). -->
<mujoco model="leap_cube_validation">
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic" impratio="10"/>
  <visual>
    <headlight ambient="0.4 0.4 0.4" diffuse="0.6 0.6 0.6"/>
    <global offwidth="1280" offheight="960"/>
  </visual>
  <default>
    <joint frictionloss="0.05" limited="true"/>
    <geom friction="0.3" solimp="0.9 0.99 0.001 0.5 4"/>
  </default>
  <asset>
    <texture name="grid" type="2d" builtin="checker" width="256" height="256"
             rgb1="0.18 0.19 0.21" rgb2="0.23 0.24 0.26"/>
    <material name="grid_mat" texture="grid" texrepeat="4 4" reflectance="0.1"/>
    <texture name="cube_tex" type="cube"
             fileright="../assets/cube_faces/right.png"
             fileleft="../assets/cube_faces/left.png"
             fileup="../assets/cube_faces/up.png"
             filedown="../assets/cube_faces/down.png"
             filefront="../assets/cube_faces/front.png"
             fileback="../assets/cube_faces/back.png"/>
    <material name="cube_mat" texture="cube_tex"/>
    <material name="hand_black" rgba="0.2 0.2 0.2 1"/>
    <material name="hand_white" rgba="0.9 0.9 0.9 1"/>{mesh_assets}
  </asset>
  <worldbody>
    <light pos="0 -0.1 0.5" dir="0 0.2 -1" diffuse="0.9 0.9 0.9" directional="true"/>
    <geom name="floor" type="plane" size="2 2 0.05" material="grid_mat" pos="0 0 -0.25"/>

    <camera name="cam1" pos="{cam1[0]:.6f} {cam1[1]:.6f} {cam1[2]:.6f}"
            xyaxes="{lookat_xyaxes(cam1[:3], cube_home)}" fovy="52"/>
    <camera name="cam2" pos="{cam2[0]:.6f} {cam2[1]:.6f} {cam2[2]:.6f}"
            xyaxes="{lookat_xyaxes(cam2[:3], cube_home)}" fovy="52"/>

    <body name="cube" pos="{_fmt(cube_home)}">
      <freejoint name="cube_freejoint"/>
      <geom name="cube_core" type="box" size="0.035 0.035 0.035" material="cube_mat"
            mass="0.108"/>
    </body>

    <body name="goal" pos="0.325 0.17 0.0475" mocap="true">
      <geom name="goal_core" type="box" size="0.035 0.035 0.035" material="cube_mat"
            contype="0" conaffinity="0"/>
    </body>

{hand_body}
  </worldbody>

  <actuator>
{hand_acts}
  </actuator>

  <sensor>
    <framepos name="cube_position" objtype="body" objname="cube"/>
    <framequat name="cube_orientation" objtype="body" objname="cube"/>
    <framepos name="trace1" objtype="body" objname="fingertip"/>
    <framepos name="trace2" objtype="body" objname="fingertip_2"/>
    <framepos name="trace3" objtype="body" objname="fingertip_3"/>
    <framepos name="trace4" objtype="body" objname="thumb_fingertip"/>
  </sensor>

  <keyframe>
    <key name="home" qpos="{HOME_QPOS}"/>
  </keyframe>
</mujoco>
"""
    out_dir = os.path.join(ROOT, "mujoco", "leap")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "task.xml")
    with open(out, "w") as f:
        f.write(xml)
    print(f"wrote {out} (+ textures in {tex_dir})")
    return out


if __name__ == "__main__":
    main()
