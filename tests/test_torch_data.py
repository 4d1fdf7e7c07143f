"""The port's host data path against argus_tpu's: the synthetic dataset
writer, the native PNG decoder, the dataset, `HostDataLoader`, and the
device feed on the CPU.

Everything here is exact: the same files, seeds and indices give the same
bytes (HDF5 datasets, PNG pixels, decoded and cropped frames, batches,
masks and xyzw poses) on both sides.
"""

import os

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from argus_tpu import native as jax_native
from argus_tpu.data import dataset as jds
from argus_tpu.data import synthetic as jsyn
from argus_tpu.geom import xyzwxyz_to_xyzxyzw_SE3 as jax_wxyz_to_xyzw
from argus_tpu.ops.image import center_crop as jax_center_crop
from argus_tpu_torch import native
from argus_tpu_torch.data import dataset as tds
from argus_tpu_torch.data import synthetic as tsyn
from argus_tpu_torch.data.feed import device_prefetch
from argus_tpu_torch.geom import xyzwxyz_to_xyzxyzw_SE3
from argus_tpu_torch.ops.image import center_crop

H, W, CROP = 40, 48, (32, 32)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """argus_tpu's synthetic dataset, 10 train + 5 test noise frames at 40x48."""
    d = str(tmp_path_factory.mktemp("data") / "ds")
    jsyn.write_synthetic_dataset(d, n_train=10, n_test=5, height=H, width=W, seed=0)
    return d


def _tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        out["attrs"] = dict(f.attrs)
        for g in ("train", "test"):
            for k in f[g]:
                out[f"{g}/{k}"] = f[g][k][()]
    return out


@pytest.mark.parametrize("mode", ["noise", "pose", "corners", "corners-faces"])
def test_synthetic_writer_matches_argus_tpu(tmp_path, mode):
    kw = dict(n_train=3, n_test=2, height=48, width=64, seed=5)
    if mode == "pose":
        kw["pose_encoded"] = True
    elif mode.startswith("corners"):
        kw["pose_encoded"] = "corners"
    if mode == "corners-faces":
        j = jsyn.write_synthetic_dataset(str(tmp_path / "j"), style=jsyn.FINETUNE_STYLE_FACES, **kw)
        t = tsyn.write_synthetic_dataset(str(tmp_path / "t"), style=tsyn.FINETUNE_STYLE_FACES, **kw)
    else:
        j = jsyn.write_synthetic_dataset(str(tmp_path / "j"), **kw)
        t = tsyn.write_synthetic_dataset(str(tmp_path / "t"), **kw)
    jt, tt = _tree(os.path.join(j, "j.hdf5")), _tree(os.path.join(t, "t.hdf5"))
    assert jt.keys() == tt.keys()
    for k in jt:
        if k == "attrs":
            assert jt[k] == tt[k]
        else:
            assert jt[k].dtype == tt[k].dtype and np.array_equal(jt[k], tt[k]), k
    pngs = sorted(os.listdir(os.path.join(j, "img")))
    assert pngs == sorted(os.listdir(os.path.join(t, "img"))) and len(pngs) == 10
    for name in pngs:
        a = np.asarray(Image.open(os.path.join(j, "img", name)))
        b = np.asarray(Image.open(os.path.join(t, "img", name)))
        assert np.array_equal(a, b), name
    if mode != "noise":
        assert np.asarray(Image.open(os.path.join(t, "img", pngs[0]))).std() > 0


@pytest.mark.parametrize("mode", [False, "corners"], ids=["noise", "corners"])
def test_rendered_arrays_are_the_written_dataset(tmp_path, mode):
    d = tsyn.write_synthetic_dataset(str(tmp_path / "ds"), n_train=4, n_test=0, height=32, width=40, seed=1,
                                     pose_encoded=mode, style=tsyn.FINETUNE_STYLE if mode else None)
    images, poses = tsyn.render_dataset_arrays(4, 32, 40, seed=1, pose_encoded=mode,
                                               style=tsyn.FINETUNE_STYLE if mode else None)
    ds = tds.CameraCubePoseDataset(tds.CameraCubePoseDatasetConfig(d, center_crop=None), train=True)
    assert images.shape == (4, 32, 40, 6) and images.dtype == np.uint8
    assert np.array_equal(images, ds.load_images_batch(range(4)))
    assert np.array_equal(xyzwxyz_to_xyzxyzw_SE3(poses), ds.cube_poses)


def test_native_decode_matches_argus_tpu(data_dir):
    assert native.available() and jax_native.available()
    paths = sorted(os.path.join(data_dir, "img", p) for p in os.listdir(os.path.join(data_dir, "img")))[:6]
    assert native.png_size(paths[0]) == jax_native.png_size(paths[0]) == (H, W)
    for crop in ((H, W), CROP, (31, 17)):
        got = native.decode_batch(paths, crop, n_threads=3)
        want = jax_native.decode_batch(paths, crop, n_threads=2)
        assert got.shape == (6, *crop, 3) and np.array_equal(got, want)
    assert np.array_equal(native.decode_batch(paths[:1], (H, W))[0], np.asarray(Image.open(paths[0])))
    with pytest.raises(IOError):
        native.decode_batch([paths[0] + ".missing"], CROP)


@pytest.mark.parametrize("decoder", ["native", "cv2"])
@pytest.mark.parametrize("crop", [CROP, None, (64, 64)], ids=["crop", "no-crop", "larger-crop"])
def test_dataset_matches_argus_tpu(data_dir, monkeypatch, decoder, crop):
    """Poses converted to xyzw at load, frames decoded, cropped (never up)
    and concatenated per camera: `load_images_batch` through the native
    decoder and through cv2, `__getitem__`, for the train and test splits."""
    if decoder == "cv2":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    for train in (True, False):
        j = jds.CameraCubePoseDataset(jds.CameraCubePoseDatasetConfig(data_dir, center_crop=crop), train=train)
        t = tds.CameraCubePoseDataset(tds.CameraCubePoseDatasetConfig(data_dir, center_crop=crop), train=train)
        assert len(t) == len(j) == (10 if train else 5) and t.n_cams == j.n_cams == 2
        assert t.cube_poses.dtype == np.float32 and np.array_equal(t.cube_poses, j.cube_poses)
        assert np.array_equal(t.q_leap, j.q_leap) and t.img_stems == j.img_stems
        idxs = [3, 0, 4, 4]
        got = t.load_images_batch(idxs, n_threads=2)
        assert got.shape == (4, *(crop if crop == CROP else (H, W)), 6)
        assert np.array_equal(got, j.load_images_batch(idxs, n_threads=2))
        item, jitem = t[1], j[1]
        assert np.array_equal(item["images"], jitem["images"]) and np.array_equal(item["cube_pose"], jitem["cube_pose"])
    with h5py.File(os.path.join(data_dir, "ds.hdf5"), "r") as f:
        raw = f["train"]["cube_poses"][()]
    tr = tds.CameraCubePoseDataset(tds.CameraCubePoseDatasetConfig(data_dir), train=True)
    assert np.array_equal(tr.cube_poses[:, 3:6], raw[:, 4:7].astype(np.float32))
    assert np.array_equal(tr.cube_poses[:, 6], raw[:, 3].astype(np.float32))


def test_pose_order_and_center_crop_match_argus_tpu():
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(5, 7)).astype(np.float32)
    assert np.array_equal(xyzwxyz_to_xyzxyzw_SE3(poses), jax_wxyz_to_xyzw(poses))
    assert torch.equal(xyzwxyz_to_xyzxyzw_SE3(torch.from_numpy(poses)), torch.from_numpy(jax_wxyz_to_xyzw(poses)))
    images = rng.integers(0, 256, (2, 3, 11, 14, 6), dtype=np.uint8)
    for crop in ((8, 8), (11, 14), (5, 9)):
        want = np.asarray(jax_center_crop(images, crop))
        assert np.array_equal(center_crop(images, crop), want)
        assert np.array_equal(center_crop(torch.from_numpy(images), crop).numpy(), want)
        assert np.array_equal(tds._center_crop_np(images[0, 0], crop), jds._center_crop_np(images[0, 0], crop))


def test_dataset_config_checks(tmp_path, data_dir):
    cfg = tds.CameraCubePoseDatasetConfig(data_dir)
    assert cfg.dataset_path == data_dir and cfg.center_crop == (256, 256)
    with pytest.raises(FileNotFoundError):
        tds.CameraCubePoseDatasetConfig(str(tmp_path / "nowhere"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(AssertionError, match="hdf5"):
        tds.CameraCubePoseDatasetConfig(str(tmp_path / "empty"))
    with pytest.raises(AssertionError):
        tds.CameraCubePoseDatasetConfig(None)


LOADER_CASES = {
    "ordered-b4": dict(batch_size=4, shuffle=False),
    "shuffled-seed0-epoch0-b4": dict(batch_size=4, shuffle=True, seed=0, epoch=0),
    "shuffled-seed7-epoch1-b3": dict(batch_size=3, shuffle=True, seed=7, epoch=1),
    "shuffled-seed7-epoch2-b5": dict(batch_size=5, shuffle=True, seed=7, epoch=2),
    "two-hosts-rank0-b3": dict(batch_size=3, shuffle=True, seed=3, process_index=0, process_count=2),
    "two-hosts-rank1-b3": dict(batch_size=3, shuffle=True, seed=3, epoch=1, process_index=1, process_count=2),
    "three-hosts-rank2-b2": dict(batch_size=2, shuffle=True, seed=1, process_index=2, process_count=3),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_host_loader_matches_argus_tpu(data_dir, case):
    """argus_tpu's batches: the per-epoch permutation, wrap-padded host
    shards, the last batch padded by repeating its first row with mask 0,
    and xyzw poses, on the train split (10 examples) and the test split."""
    kw = dict(LOADER_CASES[case])
    epoch = kw.pop("epoch", 0)
    for train in (True, False):
        loaders = []
        for mod in (jds, tds):
            ds = mod.CameraCubePoseDataset(mod.CameraCubePoseDatasetConfig(data_dir, center_crop=CROP), train=train)
            loader = mod.HostDataLoader(ds, num_workers=2, **kw)
            loader.set_epoch(epoch)
            loaders.append(loader)
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == len(loaders[1]) == len(loaders[0])
        assert np.array_equal(loaders[1]._epoch_indices(), loaders[0]._epoch_indices())
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"images", "cube_pose", "mask"}
            for k in g:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (case, train, k)
        masks = np.concatenate([g["mask"] for g in got])
        n = len(loaders[1].dataset)
        assert masks.sum() == len(loaders[1]._epoch_indices()) and masks.sum() >= n // kw.get("process_count", 1)


class _Failing:
    """A dataset whose second batch fails to load."""

    def __init__(self):
        self.cube_poses = np.zeros((6, 7), np.float32)
        self.calls = 0

    def __len__(self):
        return 6

    def load_images_batch(self, idxs, n_threads=1, pool=None):
        self.calls += 1
        if self.calls == 2:
            raise ValueError("bad frame")
        return np.zeros((len(idxs), 8, 8, 6), np.uint8)


def test_producer_error_reaches_the_consumer():
    loader = tds.HostDataLoader(_Failing(), batch_size=2, shuffle=False, num_workers=1)
    seen = []
    with pytest.raises(RuntimeError, match="producer") as err:
        for b in loader:
            seen.append(b)
    assert len(seen) == 1 and isinstance(err.value.__cause__, ValueError)


def test_feed_on_the_cpu_yields_the_same_batches(data_dir):
    ds = tds.CameraCubePoseDataset(tds.CameraCubePoseDatasetConfig(data_dir, center_crop=CROP), train=True)
    loader = tds.HostDataLoader(ds, batch_size=4, shuffle=True, seed=2, num_workers=1)
    want = list(loader)
    got = list(device_prefetch(loader, "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert np.array_equal(g[k].numpy(), w[k])
