"""The streaming input feed: rendered batches flow straight into the train step.

Port of `argus_tpu/data/streaming.py`. The on-disk datagen writes PNGs and
an HDF5 that training reads back; this path skips the round trip: a daemon
producer thread pulls (images, poses) batches from a render source (the
Unity bridge, `unity_render_source`, or any callable) into a bounded queue
of `prefetch` batches, and the training loop consumes them like any other
host loader. On the card the batches go through `data.feed.device_prefetch`
to `train.make_train_step`'s step.

    source = unity_render_source(gen_cfg)        # or any render_fn
    loader = StreamingRenderLoader(source, batch_size=32, n_batches=1000)
    for batch in device_prefetch(loader): state, loss = step(state, batch)

A producer's exception ends the stream and is raised again in the
consumer, as the same exception object.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Tuple

import numpy as np

# a render source maps a batch size to (images uint8 (B, H, W, 3 * n_cams),
# cube poses float32 (B, 7) with xyzw quaternions in the MJPC world frame)
RenderSource = Callable[[int], Tuple[np.ndarray, np.ndarray]]


class StreamingRenderLoader:
    """Bounded-queue streaming feed with `HostDataLoader`'s batch schema
    ({"images" uint8 (B, H, W, 3n), "cube_pose" f32 (B, 7) xyzw, "mask" f32
    ones (B,)}), so the train step consumes either."""

    def __init__(self, render_fn: RenderSource, batch_size: int, n_batches: int, prefetch: int = 2) -> None:
        self.render_fn = render_fn
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n_batches

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []

        def producer():
            try:
                for _ in range(self.n_batches):
                    images, poses = self.render_fn(self.batch_size)
                    if images.dtype != np.uint8 or poses.shape[-1] != 7:
                        raise ValueError(f"a render source returns uint8 images and (B, 7) poses, "
                                         f"not {images.dtype} and {poses.shape}")
                    q.put({
                        "images": images,
                        "cube_pose": poses.astype(np.float32),
                        "mask": np.ones((self.batch_size,), np.float32),
                    })
            except Exception as e:  # handed to the consumer, which raises it
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise error[0]


def unity_render_source(cfg, center_crop=(256, 256)) -> RenderSource:
    """A render source backed by the live Unity player (`cfg` a
    `datagen.GenerateDataConfig`).

    Each call renders `batch_size` fresh domain-randomised scenes, the cube
    poses drawn from the MJPC states in `cfg.mjpc_data_path` in turn
    (cycled): the on-disk datagen's distribution, without the PNG round
    trip. The player boots at the first call (`datagen.unity_setup`, one
    area per row). Needs `mlagents_envs` and the Unity executable."""
    from argus_tpu_torch import datagen as dg
    from argus_tpu_torch.geom import convert_pose_mjpc_to_unity, convert_pose_unity_to_mjpc, xyzwxyz_to_xyzxyzw_SE3

    rng = np.random.default_rng(cfg.seed)
    cube_mjpc, q_leap = dg.load_mjpc_states(cfg.mjpc_data_path)
    cube_unity = convert_pose_mjpc_to_unity(cube_mjpc)
    cursor = {"i": 0}
    env_state = {}

    def render_fn(batch_size: int):
        if "env" not in env_state:
            env_state["env"], env_state["behavior"], env_state["act_size"] = dg.unity_setup(
                cfg.env_exe_path, n_agents=batch_size
            )
        env, behavior, act_size = env_state["env"], env_state["behavior"], env_state["act_size"]

        i = cursor["i"]
        idx = np.arange(i, i + batch_size) % cube_unity.shape[0]
        cursor["i"] = (i + batch_size) % cube_unity.shape[0]

        cam1 = dg.generate_random_camera_poses(
            batch_size, cfg.cam1_nominal[:3], cfg.cam1_nominal[3:], cfg.bounds_trans, cfg.quat_stdev, rng
        )
        cam2 = dg.generate_random_camera_poses(
            batch_size, cfg.cam2_nominal[:3], cfg.cam2_nominal[3:], cfg.bounds_trans, cfg.quat_stdev, rng
        )
        light = dg.generate_random_light_source_poses(batch_size, rng)
        action = dg.pack_actions(cube_unity[idx], q_leap[idx], cam1, cam2, light, cfg.cam_rgb_range, rng, act_size)
        env.reset()
        env.set_actions(behavior, dg._make_action_tuple(action))
        env.step()
        steps, _ = env.get_steps(behavior)
        cam1_obs, cam2_obs = steps.obs[0], steps.obs[1]  # (B, 3, H, W) float in [0, 1]

        imgs = np.concatenate([cam1_obs, cam2_obs], axis=1)  # (B, 6, H, W)
        imgs = (np.transpose(imgs, (0, 2, 3, 1)) * 255).astype(np.uint8)  # NHWC
        if center_crop:
            H, W = imgs.shape[1:3]
            ch, cw = center_crop
            top, left = (H - ch) // 2, (W - cw) // 2
            imgs = imgs[:, top : top + ch, left : left + cw]

        poses_mjpc = convert_pose_unity_to_mjpc(cube_unity[idx])  # wxyz
        poses_xyzw = xyzwxyz_to_xyzxyzw_SE3(poses_mjpc)
        return imgs, poses_xyzw.astype(np.float32)

    return render_fn
