"""`scripts/make_mujoco_scene_torch.py` against `scripts/make_mujoco_scene.py`.

Both scripts are loaded from `scripts/` and run with their `ROOT` and
`REF_HAND_XML_CANDIDATES` pointed into temporary roots of their own (the
repository's `mujoco/` is never written): meshless, and through the mesh path
on a tiny rig model built here (two group-2 mesh geoms from a tetrahedron OBJ,
the white tip duplicated in another group as the LEAP rig's source model has
it). `task.xml`, the six cube textures and the converted OBJ files must be
byte-equal, the placements and printed lines equal, and MuJoCo must load the
twin's scene with its cameras and the home keyframe. Host only, a few seconds.
"""

import importlib.util
import os

import pytest

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("imageio")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ("right", "left", "front", "back", "up", "down")

TETRA_OBJ = "v 0 0 0\nv 0.02 0 0\nv 0 0.02 0\nv 0 0 0.02\nf 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n"
# a palm and a fingertip body, as the LEAP rig names them; the tip's white mesh twice in group 2 and once
# in group 1, the palm's mesh once in group 2
RIG_XML = """<mujoco model="tiny_rig">
  <asset>
    <mesh name="palm_lower" file="tetra.obj"/>
    <mesh name="white_tip_1" file="tetra.obj" scale="0.5 0.5 0.5"/>
  </asset>
  <worldbody>
    <body name="palm" pos="0 0 0.1" quat="0.7071 0 0.7071 0">
      <geom type="mesh" mesh="palm_lower" pos="0.01 0 0" group="2"/>
      <body name="fingertip" pos="0 0.05 0">
        <joint name="0" axis="0 0 -1"/>
        <geom type="mesh" mesh="white_tip_1" pos="0 -0.01 0.002" group="2"/>
        <geom type="mesh" mesh="white_tip_1" pos="0 -0.01 0.002" group="2"/>
        <geom type="mesh" mesh="white_tip_1" pos="0 -0.01 0.002" group="1"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    """(original, twin), each loaded once from its file."""
    return _load("make_mujoco_scene"), _load("make_mujoco_scene_torch")


@pytest.fixture
def rig(tmp_path):
    d = tmp_path / "rig"
    d.mkdir()
    (d / "tetra.obj").write_text(TETRA_OBJ)
    (d / "leap_hand.xml").write_text(RIG_XML)
    return str(d / "leap_hand.xml")


def _run_main(module, root, candidates, monkeypatch, capsys):
    """`main()` with the module's ROOT and rig candidates patched: (task.xml path, printed lines with the
    root replaced by "<root>")."""
    monkeypatch.setattr(module, "ROOT", str(root))
    monkeypatch.setattr(module, "REF_HAND_XML_CANDIDATES", tuple(candidates))
    capsys.readouterr()
    out = module.main()
    printed = capsys.readouterr().out.replace(str(root), "<root>")
    return out, printed


def _tree(root):
    """{relative path: bytes} of every file under `root`/mujoco."""
    files = {}
    for d, _, names in os.walk(os.path.join(root, "mujoco")):
        for n in names:
            p = os.path.join(d, n)
            files[os.path.relpath(p, root)] = open(p, "rb").read()
    return files


@pytest.mark.parametrize("with_rig", [False, True], ids=["meshless", "mesh"])
def test_twin_writes_the_originals_scene_and_textures(scripts, rig, tmp_path, monkeypatch, capsys, with_rig):
    roots = tmp_path / "original", tmp_path / "twin"
    runs = [_run_main(m, r, [rig] if with_rig else [], monkeypatch, capsys) for m, r in zip(scripts, roots)]
    (want_xml, want_printed), (got_xml, got_printed) = runs
    assert got_xml == os.path.join(roots[1], "mujoco", "leap", "task.xml") and os.path.exists(got_xml)
    assert got_printed == want_printed
    want, got = _tree(roots[0]), _tree(roots[1])
    expected = {os.path.join("mujoco", "leap", "task.xml")} | {
        os.path.join("mujoco", "assets", "cube_faces", f"{f}.png") for f in FACES}
    if with_rig:
        expected |= {os.path.join("mujoco", "assets", "leap_meshes", f"{n}.obj") for n in ("palm_lower", "white_tip_1")}
    assert set(got) == set(want) == expected
    for path in sorted(expected):
        assert got[path] == want[path], path
    scene = got[os.path.join("mujoco", "leap", "task.xml")].decode()
    assert ("palm_lower" in scene) == with_rig and ("white_tip_1" in scene) == with_rig


def test_mesh_conversion_matches_the_original(scripts, rig, tmp_path):
    """`extract_hand_meshes`: byte-equal OBJ files and equal placements; the duplicate white tip is kept
    once, with the white material, and the group-1 copy is left out."""
    out = [m.extract_hand_meshes(rig, str(tmp_path / name)) for m, name in zip(scripts, ("original", "twin"))]
    (want_names, want_geoms), (got_names, got_geoms) = out
    assert got_names == want_names == ["palm_lower", "white_tip_1"]
    assert got_geoms == want_geoms
    assert [g[0] for g in got_geoms["fingertip"]] == ["white_tip_1"] and got_geoms["fingertip"][0][3] == "hand_white"
    assert [g[3] for g in got_geoms["palm"]] == ["hand_black"]
    for n in got_names:
        want = (tmp_path / "original" / f"{n}.obj").read_bytes()
        assert (tmp_path / "twin" / f"{n}.obj").read_bytes() == want and want.count(b"\nf ") == 4


def test_mujoco_loads_the_twins_scene(scripts, rig, tmp_path, monkeypatch, capsys):
    """Meshless from the XML text, and with the converted meshes from its file: the cameras, the home
    keyframe (cube 7 + hand 16) and the 16 actuators."""
    twin = scripts[1]
    path, _ = _run_main(twin, tmp_path / "meshless", [], monkeypatch, capsys)
    monkeypatch.chdir(os.path.dirname(path))  # the texture files are named relative to the scene
    m = mujoco.MjModel.from_xml_string(open(path).read())
    for name in ("cam1", "cam2"):
        assert mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_CAMERA, name) >= 0
    key = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_KEY, "home")
    assert key >= 0 and m.nq == 23 and m.nu == 16 and m.nmesh == 0
    assert m.key_qpos[key][:3].tolist() == [0.1, 0.025, 0.035]
    path, _ = _run_main(twin, tmp_path / "mesh", [rig], monkeypatch, capsys)
    m = mujoco.MjModel.from_xml_path(path)
    assert m.nmesh == 2 and m.nq == 23 and mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_KEY, "home") >= 0
