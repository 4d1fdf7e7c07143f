"""Serving: uint8 camera frames -> SE(3) cube poses, as a long-lived object,
and the exported artifact that serves without model code.

Port of `argus_tpu/serve.py` for both model families. `Estimator` reads the
model family and config from a format-2 checkpoint's metadata (an explicit
config overrides), picks the serving configuration by batch size, loads the
weights through the weight bridge, folds every frozen BN affine into its
conv once, and warms the model up. Its program (`PoseProgram`) converts
uint8 frames with ``u8.float() / 255.0``, runs the model, then `se3_exp`
(NCameraCNN) or `fit_pose` through the nominal cameras at the serving
resolution (CubeKeypointNet); `predict` returns (B, 7) xyzw poses (or
MuJoCo wxyz order) as numpy.

On the card `predict` replays one CUDA graph per input shape, the
counterpart of argus_tpu's one `jax.jit` program per shape: the graph runs
from the uint8 input to the pose (`PoseNet`); the keypoint family's pose fit
runs after the replay on the card, since its `torch.linalg` solve, SVD and
determinant check their results on the host, which a capture forbids. A
shape is captured at its first use, after `capture.WARMUP_STEPS` eager
calls (the constructor does this for its `batch_size`); a capture that
fails raises. The frames go through a pinned host buffer of that shape into
the graph's static input, chunk by chunk (a few host threads copy the
chunks, each chunk's upload queued once it is copied), and the poses come
back through another pinned buffer. On the
CPU `predict` runs the same program eagerly.

From batch `SERVING_FUSED_MIN_BATCH` up, `throughput_tuned_config` switches a
bottleneck backbone to bf16, frozen BN and the fused kernels under "auto":
on the card, the stem, the stage-0 chain, the stage 1-3 projection blocks
and the identity blocks run the hand-written CUDA kernels wherever
`models.resnet.AUTO_FUSE` names them, each as one `argus::` op
(`torch.library`). A BasicBlock backbone (the keypoint family's ResNet-18)
takes bf16 and folded BN but keeps its convolutions unfused, as argus_tpu
does. Below it the f32 model runs with plain convolutions.

`export_estimator` writes the Estimator's program, weights included, to one
`torch.export` file; `ExportedEstimator` loads it with no checkpoint and no
module of `argus_tpu_torch.models` (the `argus::` ops are registered by
`argus_tpu_torch.ops.kernels`) and serves it as the Estimator does. This
module imports the model and checkpoint code only inside `Estimator`.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from argus_tpu_torch import resolve_device
from argus_tpu_torch.capture import WARMUP_STEPS, CapturedCall
from argus_tpu_torch.geom import se3_exp, xyzxyzw_to_xyzwxyz_SE3

# fuse fields that both tuners switch, in one place
_FUSE_FIELDS = ("fuse_block", "fuse_proj", "fuse_stem", "fuse_stage")

# batch size from which batched serving takes the fused bf16 path, the
# crossover argus_tpu chose
SERVING_FUSED_MIN_BATCH = 8

# a batch's staging: bytes of frames a host thread copies into pinned memory
# before their upload is queued, and the threads that copy
UPLOAD_CHUNK = 4 << 20
UPLOAD_THREADS = 4


def _bottleneck(cfg) -> bool:
    """Whether the config's backbone is built from bottleneck blocks, read
    from its block class rather than a list of names."""
    from argus_tpu_torch.models.resnet import BACKBONE_BLOCKS, BottleneckBlock

    return BACKBONE_BLOCKS.get(getattr(cfg, "backbone", "")) is BottleneckBlock


def latency_tuned_config(cfg):
    """Single-frame serving: every fused kernel off. No-op for configs
    without fuse fields."""
    names = {f.name for f in dataclasses.fields(cfg)} & {*_FUSE_FIELDS, "fuse_pointwise"}
    if not names:
        return cfg
    return dataclasses.replace(cfg, **{name: "off" for name in names})


def throughput_tuned_config(cfg):
    """Batched serving: at eval exact BN equals frozen BN (both apply the
    running statistics), so fold BN and run bf16; the fused kernels engage
    for bottleneck backbones only, under "auto" (argus_tpu sets "on"): each
    kernel function runs where `models.resnet.AUTO_FUSE` measured it faster
    than cuDNN. BasicBlock backbones stay unfused, as in argus_tpu. No-op
    for configs without fuse fields."""
    names = {f.name for f in dataclasses.fields(cfg)} & set(_FUSE_FIELDS)
    if not names:
        return cfg
    on = "auto" if _bottleneck(cfg) else "off"
    return dataclasses.replace(
        cfg, bn_frozen=True, bn_frozen_affine=True, dtype="bfloat16", **{name: on for name in names}
    )


def serving_tuned_config(cfg, batch_size: int):
    """The serving configuration for a batch size: fused bf16 from
    `SERVING_FUSED_MIN_BATCH` up, plain f32 below."""
    if batch_size >= SERVING_FUSED_MIN_BATCH:
        return throughput_tuned_config(cfg)
    return latency_tuned_config(cfg)


# ───────────────────────────── the program ─────────────────────────────


class PoseNet(nn.Module):
    """uint8 frames (B, H, W, 3 * n_cams) -> the part of the program a CUDA
    graph holds: `se3_exp` of NCameraCNN's output, (B, 7) poses, or
    CubeKeypointNet's corners uv, (B, n_cams, 8, 2)."""

    def __init__(self, model: nn.Module, keypoint: bool) -> None:
        super().__init__()
        self.model = model
        self.keypoint = keypoint

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        pred = self.model(images_u8.float() / 255.0)
        return pred[0] if self.keypoint else se3_exp(pred)


class KeypointFit(nn.Module):
    """The keypoint family's pose fit, uv -> (B, 7) poses through the
    cameras `cam_P` (triangulation, then Procrustes)."""

    def __init__(self, cam_P: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("cam_P", cam_P)

    def forward(self, uv: torch.Tensor) -> torch.Tensor:
        from argus_tpu_torch.models.keypoint_net import fit_pose

        return fit_pose(self.cam_P, uv)


class PoseProgram(nn.Module):
    """uint8 frames -> (B, 7) xyzw poses: `net`, then `fit` where the model
    family has one. `net` is its own submodule so that a served copy can
    replay it as a CUDA graph and an exported program keeps its boundary."""

    def __init__(self, net: nn.Module, fit: Optional[nn.Module] = None) -> None:
        super().__init__()
        self.net = net
        self.fit = fit

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        out = self.net(images_u8)
        return out if self.fit is None else self.fit(out)


class ReplayedNet(nn.Module):
    """`net` on the card as one `capture.CapturedCall` per input shape (and
    per `key()`, when given): its first calls eager, then one CUDA graph
    replayed. The input must be the same tensor at every call of a shape
    (`Server`'s staging buffer): the graph reads it in place."""

    def __init__(self, net: nn.Module, key=None) -> None:
        super().__init__()
        self.net = net
        self.key = key
        self.calls = {}  # (shape, key()) -> (CapturedCall, the input's address)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = (tuple(x.shape), self.key() if self.key is not None else None)
        if k not in self.calls:
            self.calls[k] = (CapturedCall(functools.partial(self.net, x), x.device), x.data_ptr())
        call, ptr = self.calls[k]
        if x.data_ptr() != ptr:
            raise ValueError("a replayed net takes the same input tensor at every call of a shape")
        return call()


class _Staging:
    """One input shape's pinned host buffers and the static device input."""

    def __init__(self, shape, device) -> None:
        self.host_in = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        self.dev_in = torch.empty(shape, dtype=torch.uint8, device=device)
        self.host_out = None


class Server:
    """A `PoseProgram`-shaped module (uint8 frames -> poses, `net` its first
    submodule) served on its device, numpy in and out. On the card its `net`
    is replaced by a `ReplayedNet` (`key` adds to the shape what a captured
    graph depends on), the frames are copied into a pinned buffer, uploaded
    asynchronously into the graph's static input, and the poses come back
    through a pinned buffer; on the CPU the program runs eagerly."""

    def __init__(self, program: nn.Module, device: torch.device, key=None) -> None:
        self.device = device
        if device.type == "cuda":
            program.net = ReplayedNet(program.net, key)
        self.program = program
        self.staging = {}  # shape -> _Staging
        self._copiers = None  # the staging copies' threads, made at the first batch that needs them

    # calls that reach the capture of a new shape (the eager warm-up first)
    @property
    def warmup_calls(self) -> int:
        return WARMUP_STEPS + 1 if self.device.type == "cuda" else 1

    def captured(self) -> list:
        """The (shape, key) of every graph captured so far (none on the CPU)."""
        calls = getattr(self.program.net, "calls", {})
        return [k for k, (call, _) in calls.items() if call.graph is not None]

    @torch.inference_mode()
    def stage(self, images: np.ndarray) -> _Staging:
        """Copy a batch into its shape's pinned buffer and upload it into the
        static device input, queued on the current stream. A batch of more
        than `UPLOAD_CHUNK` bytes goes in chunks of about that size, copied
        by `UPLOAD_THREADS` host threads (numpy releases the GIL), each
        chunk's upload queued as soon as its copy is done, so the copies
        overlap one another and the uploads."""
        st = self.staging.get(images.shape)
        if st is None:
            st = self.staging[images.shape] = _Staging(images.shape, self.device)
        host = st.host_in.numpy()
        rows = max(1, UPLOAD_CHUNK // max(1, images[0].nbytes))
        spans = [(i, min(i + rows, images.shape[0])) for i in range(0, images.shape[0], rows)]
        if len(spans) == 1:
            np.copyto(host, images)
            st.dev_in.copy_(st.host_in, non_blocking=True)
            return st
        if self._copiers is None:
            self._copiers = ThreadPoolExecutor(UPLOAD_THREADS, thread_name_prefix="argus-stage")
        copies = [self._copiers.submit(np.copyto, host[a:b], images[a:b]) for a, b in spans]
        for (a, b), copy in zip(spans, copies):
            copy.result()
            st.dev_in[a:b].copy_(st.host_in[a:b], non_blocking=True)
        return st

    @torch.inference_mode()
    def __call__(self, images: np.ndarray) -> np.ndarray:
        if self.device.type != "cuda":
            return self.program(torch.from_numpy(images).to(self.device)).cpu().numpy()
        st = self.stage(images)
        pose = self.program(st.dev_in)
        if st.host_out is None:
            st.host_out = torch.empty(pose.shape, dtype=pose.dtype, pin_memory=True)
        st.host_out.copy_(pose, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return st.host_out.numpy().copy()


def _fuse_flags_of(backbone):
    """What an estimator's graphs depend on besides the input shape: the
    backbone's fuse flags, read at each call."""
    return lambda: tuple(getattr(backbone, name) for name in (*_FUSE_FIELDS, "fuse_pointwise"))


def _check_images(images) -> None:
    if not isinstance(images, np.ndarray) or images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError("images must be a uint8 numpy array of shape (B, H, W, 3 * n_cams)")


# ───────────────────────────── the estimator ─────────────────────────────


def load_model(checkpoint_path: str, model_config=None, batch_size: Optional[int] = None):
    """(model on the CPU with the checkpoint's weights, its config, model
    type, the checkpoint's metadata): the family and config from the
    metadata unless `model_config` overrides them, and with `batch_size`
    the serving configuration for it (`serving_tuned_config`)."""
    from argus_tpu_torch.checkpoint import load_checkpoint_with_meta
    from argus_tpu_torch.models import resolve_model
    from argus_tpu_torch.models.jax_import import state_dict_from_variables

    raw, meta = load_checkpoint_with_meta(checkpoint_path)
    model, cfg, model_type = resolve_model(meta, model_config)
    if batch_size is not None:
        cfg = serving_tuned_config(cfg, batch_size)
        model, _, _ = resolve_model({}, cfg)
    model.load_state_dict(state_dict_from_variables(raw["params"], raw["batch_stats"], model.state_dict()),
                          strict=True)
    return model, cfg, model_type, meta


class Estimator:
    """uint8 images -> SE(3) cube-pose estimator.

    `device=None` runs on CUDA and raises without a card; pass
    `device="cpu"` for the plain PyTorch path. On the card a captured graph
    holds the model as it was at its capture: one graph per input shape and
    per setting of the backbone's fuse flags (a caller may switch them
    between predicts); build a new Estimator after changing its weights."""

    def __init__(
        self,
        checkpoint_path: str,
        model_config=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        batch_size: int = 1,
        device=None,
    ) -> None:
        device = resolve_device(device)
        model, cfg, model_type, meta = load_model(checkpoint_path, model_config, batch_size)
        # an explicit height/width wins, then the checkpoint's training crop, then 256
        if height is None or width is None:
            crop = meta.get("center_crop")
            mh, mw = (int(v) for v in crop) if crop else (256, 256)
            height = mh if height is None else height
            width = mw if width is None else width
        self._serve(model, cfg, model_type, (height, width), batch_size, device)

    @classmethod
    def from_model(cls, model: nn.Module, model_type: str = "pose_cnn", hw=(256, 256), batch_size: int = 1,
                   device=None) -> "Estimator":
        """An estimator of a model as it is (its config unchanged, its
        weights its own), moved to `device`: argus_tpu's
        `make_pose_estimator` builds the same program from a model and its
        variables."""
        est = cls.__new__(cls)
        est._serve(model, model.cfg, model_type, tuple(hw), batch_size, resolve_device(device))
        return est

    def _serve(self, model, cfg, model_type: str, hw: tuple, batch_size: int, device) -> None:
        from argus_tpu_torch.models.keypoint_net import nominal_camera_matrices

        self.device, self.cfg, self.model_type, self.hw, self.batch_size = device, cfg, model_type, hw, batch_size
        self.model = model.to(device).eval()
        self.model.backbone.fold_frozen_bn()
        keypoint = model_type == "keypoint"
        self.cam_P = nominal_camera_matrices(*hw).to(device) if keypoint else None
        net, fit = PoseNet(self.model, keypoint), KeypointFit(self.cam_P) if keypoint else None
        self.program = PoseProgram(net, fit)  # what `export` writes
        self.server = Server(PoseProgram(net, fit), device, key=_fuse_flags_of(self.model.backbone))
        # warm up (and on the card capture) so the first real call pays no first-use costs
        dummy = np.zeros((batch_size, *hw, 3 * cfg.n_cams), np.uint8)
        for _ in range(self.server.warmup_calls):
            self.predict(dummy)

    def predict(self, images: np.ndarray, wxyz: bool = False) -> np.ndarray:
        """Poses for a uint8 batch (B, H, W, 3 * n_cams): (B, 7), xyzw
        quaternions, or MuJoCo's wxyz order with `wxyz=True`."""
        _check_images(images)
        poses = self.server(images)
        return xyzxyzw_to_xyzwxyz_SE3(poses) if wxyz else poses

    def predict_frames(self, frames: Sequence[np.ndarray], wxyz: bool = False) -> np.ndarray:
        """One pose from per-camera frames [(H, W, 3), ...] (uint8)."""
        stacked = np.concatenate(frames, axis=-1)[None]
        return self.predict(stacked, wxyz=wxyz)[0]

    def export(self, out_path: str) -> None:
        """Write the program at this estimator's input shape, weights and the
        folded BN included, to one `torch.export` file (traced with
        gradients off, so the fused kernels read the folded cache)."""
        example = torch.zeros((self.batch_size, *self.hw, 3 * self.cfg.n_cams), dtype=torch.uint8,
                              device=self.device)
        with torch.no_grad():
            ep = torch.export.export(self.program, (example,), preserve_module_call_signature=("net",))
        torch.export.save(ep, out_path)


# ───────────────────────────── export ─────────────────────────────


def export_estimator(
    checkpoint_path: str,
    out_path: str,
    *,
    model_config=None,
    height: Optional[int] = None,
    width: Optional[int] = None,
    batch_size: int = 1,
    device=None,
) -> None:
    """Write the Estimator's uint8 -> SE(3) program, weights included, to
    one file through `torch.export` (`Estimator.export`), at the shape the
    estimator serves (the checkpoint's crop unless height/width say
    otherwise). `ExportedEstimator` loads it in a process with no checkpoint
    and no model code. argus_tpu's `platforms` (lowering for another
    backend from this host) has no counterpart: the program is traced on
    `device` (CUDA by default), where its `argus::` ops are the kernels, and
    is served on a device of that type."""
    Estimator(checkpoint_path, model_config, height, width, batch_size, device).export(out_path)


class ExportedEstimator:
    """Serving-side loader of `export_estimator` files: the batch size and
    frame shape come from the program's input, and `predict` serves it as
    `Estimator.predict` does (on the card its `net` replayed as one CUDA
    graph, the keypoint fit after it). Imports no model code: the program's
    `argus::` ops are registered by `argus_tpu_torch.ops.kernels`."""

    def __init__(self, path: str, device=None) -> None:
        self.device = resolve_device(device)
        ep = torch.export.load(path)
        (name,) = ep.graph_signature.user_inputs
        spec = next(n.meta["val"] for n in ep.graph.nodes if n.name == name)
        self.batch_size, self.height, self.width, self.channels = spec.shape
        if spec.device.type != self.device.type:
            raise ValueError(f"{path} was exported for {spec.device.type}; export it on {self.device.type}")
        with warnings.catch_warnings():  # unflatten's notes on the lifted constants
            warnings.filterwarnings("ignore", message="Attempted to insert a get_attr Node")
            program = torch.export.unflatten(ep)
        self.server = Server(program, self.device)
        dummy = np.zeros(tuple(spec.shape), np.uint8)
        for _ in range(self.server.warmup_calls):
            self.server(dummy)

    def predict(self, images: np.ndarray, wxyz: bool = False) -> np.ndarray:
        """Poses for a uint8 batch of the exported shape: (B, 7), xyzw, or
        wxyz with `wxyz=True`."""
        _check_images(images)
        if images.shape != (self.batch_size, self.height, self.width, self.channels):
            raise ValueError(f"the program was exported for frames of shape "
                             f"{(self.batch_size, self.height, self.width, self.channels)}, got {images.shape}")
        poses = self.server(images)
        return xyzxyzw_to_xyzwxyz_SE3(poses) if wxyz else poses
