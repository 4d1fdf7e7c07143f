"""The port's host utilities (`argus_tpu_torch.utils`) against argus_tpu's:
the config-error directory tree (the same string), the host spaghetti
drawer (the same pixels under the same numpy seed), `get_pose` (1e-5 on
poses of order 1) and `time_fn`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from argus_tpu import utils as ju
from argus_tpu_torch import utils as tu


def _tree(root):
    (root / "outputs" / "models" / "run_b").mkdir(parents=True)
    (root / "outputs" / "models" / "run_a" / "deep").mkdir(parents=True)
    for rel in ("outputs/models/z.ckpt", "outputs/models/a.ckpt", "outputs/models/notes.txt",
                "outputs/models/run_a/m.ckpt", "outputs/models/run_a/deep/x.ckpt", "outputs/models/run_b/y.json"):
        (root / rel).write_text("x")
    return str(root / "outputs")


def test_get_tree_string_matches_argus_tpu(tmp_path):
    path = _tree(tmp_path)
    got = tu.get_tree_string(path, "ckpt")
    assert got == ju.get_tree_string(path, "ckpt")
    assert "└── z.ckpt" in got and "notes.txt" not in got and "│   " in got
    assert tu.get_tree_string(str(tmp_path / "missing"), "ckpt") == ju.get_tree_string(str(tmp_path / "missing"),
                                                                                        "ckpt")


@pytest.mark.parametrize("n_arcs, size", [(10, (96, 64)), (3, (33, 57))])
def test_draw_spaghetti_matches_argus_tpu(n_arcs, size):
    base = (np.random.default_rng(5).random((size[1], size[0], 3)) * 255).astype(np.uint8)
    got = tu.draw_spaghetti(Image.fromarray(base.copy()), n_arcs, rng=np.random.default_rng(11))
    want = ju.draw_spaghetti(Image.fromarray(base.copy()), n_arcs, rng=np.random.default_rng(11))
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(got), base)  # arcs were drawn


def test_get_pose_matches_argus_tpu():
    rng = np.random.default_rng(2)
    images = rng.random((4, 8, 8, 6)).astype(np.float32)
    w = (rng.normal(size=(8 * 8 * 6, 6)) * 0.05).astype(np.float32)
    got = tu.get_pose(torch.from_numpy(images), lambda x: x.reshape(4, -1) @ torch.from_numpy(w))
    want = ju.get_pose(jnp.asarray(images), lambda x: x.reshape(4, -1) @ jnp.asarray(w))
    assert got.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_time_fn_returns_the_result_and_seconds():
    calls = []

    def fn():
        calls.append(1)
        return {"a": torch.ones(3), "b": (torch.zeros(2), 5)}

    result, seconds = tu.time_fn(fn, warmup=2)
    assert len(calls) == 3 and seconds >= 0.0
    assert torch.equal(result["a"], torch.ones(3))
