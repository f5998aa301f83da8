"""Checkpoints of the splat map and of both runtimes, as plain .npz.

Counterpart of gslam_tpu/runtime/checkpoint.py, with the JAX package's
keys, so a checkpoint written by either package loads into the other:
  * `save_map` / `load_map`: the splat buffer only (`gmap/<field>`);
  * `save_checkpoint` / `restore_system`: a `SlamSystem` (the actor
    runtime) mid-run: map, Adam moments (`adam_mu/`, `adam_nu/`,
    `adam/count`), keyframe store (`kf/`), pose optimizer (`pose_opt/`),
    `rng/key` (a uint32 pair), `K`, both actors' frames (`be_frames/`,
    `fe_frames/`), the frontend's times and losses and the host
    bookkeeping (`meta_json`);
  * `save_fused_checkpoint` / `load_fused_checkpoint`: every FusedState
    leaf under its path (`leaf/.gmap.means`, `leaf/.opt_state.mu['means']`,
    ...), `meta/format` = 2, `meta/shape` and the frames' metadata.
`fused_state_from_numpy` carries such leaves across. The PRNG `key` keeps
its [2] shape but not its meaning: a JAX key seeds the port's generator,
whose stream differs from JAX's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from gslam_tpu_torch import resolve_device
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.io.frames import Frame
from gslam_tpu_torch.mapping.backend_ops import PoseAdamState
from gslam_tpu_torch.mapping.gaussians import (
    TRAINABLE_FIELDS, GaussianMap, gaussian_map_from_numpy, gaussian_map_to_numpy,
)
from gslam_tpu_torch.mapping.keyframes import keyframes_from_numpy, keyframes_to_numpy
from gslam_tpu_torch.mapping.optimizer import adam_state_from_numpy, adam_state_to_numpy

FORMAT = 2


def save_map(path, gmap: GaussianMap, extra: dict | None = None):
    """Splat-buffer-only snapshot (+ optional named extra arrays)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"gmap/{k}": v.detach().cpu().numpy() for k, v in gmap._asdict().items()}
    for k, v in (extra or {}).items():
        arrays[f"extra/{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path, device: str | torch.device | None = None) -> tuple[GaussianMap, dict]:
    with np.load(path, allow_pickle=False) as data:
        fields = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith("gmap/")}
        extra = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith("extra/")}
    return gaussian_map_from_numpy(fields, device), extra


# ---------------- the actor runtime's resumable checkpoints ----------------


def _frames_to_arrays(frames, prefix):
    """Pack stripped Frame trajectory state into arrays."""
    n = len(frames)
    eye = np.eye(4, dtype=np.float32)

    def stack(values, default, shape):
        return (np.stack([np.asarray(v, np.float32) if v is not None else default
                          for v in values]) if n else np.zeros(shape, np.float32))

    return {
        f"{prefix}/index": np.asarray([f.index for f in frames], np.int64),
        f"{prefix}/timestamp": np.asarray(
            [f.timestamp if f.timestamp is not None else 0.0 for f in frames], np.float64),
        f"{prefix}/est_pose": stack([f.est_pose for f in frames], eye, (0, 4, 4)),
        f"{prefix}/has_est": np.asarray([f.est_pose is not None for f in frames], bool),
        f"{prefix}/gt_pose": stack([f.gt_pose for f in frames], eye, (0, 4, 4)),
        f"{prefix}/has_gt": np.asarray([f.gt_pose is not None for f in frames], bool),
        f"{prefix}/exposure": stack([f.exposure for f in frames], np.zeros(2, np.float32),
                                    (0, 2)),
    }


def _frames_from_arrays(data, prefix, camera):
    frames = []
    for i in range(len(data[f"{prefix}/index"])):
        frames.append(Frame(
            image=None,
            timestamp=float(data[f"{prefix}/timestamp"][i]),
            camera=camera,
            index=int(data[f"{prefix}/index"][i]),
            gt_pose=data[f"{prefix}/gt_pose"][i] if data[f"{prefix}/has_gt"][i] else None,
            est_pose=data[f"{prefix}/est_pose"][i] if data[f"{prefix}/has_est"][i] else None,
            exposure=data[f"{prefix}/exposure"][i],
        ))
    return frames


def save_checkpoint(path, system):
    """Serialize a SlamSystem mid-run: everything `restore_system` needs to
    continue it."""
    be, fe = system.backend, system.frontend
    arrays = {f"gmap/{k}": v for k, v in gaussian_map_to_numpy(be.gmap).items()}
    for k, v in adam_state_to_numpy(be.opt_state).items():
        arrays["adam/count" if k == "count" else "adam_" + k] = v
    arrays.update({f"kf/{k}": v for k, v in keyframes_to_numpy(be.kf).items()})
    arrays.update({f"pose_opt/{k}": v.cpu().numpy() for k, v in be.pose_opt._asdict().items()})
    arrays["rng/key"] = be.key.numpy().astype(np.uint32)
    arrays["K"] = be.K.cpu().numpy()
    arrays.update(_frames_to_arrays(be.frames, "be_frames"))
    arrays.update(_frames_to_arrays(fe.frames, "fe_frames"))
    arrays["fe/track_times"] = np.asarray(fe.track_times, np.float64)
    arrays["fe/losses"] = np.asarray(fe.losses, np.float64)
    meta = {
        "kf_order": be.kf_order,
        "kf_frame_idx": {str(k): v for k, v in be.kf_frame_idx.items()},
        "pose_graph": {str(k): sorted(v) for k, v in be.pose_graph.items()},
        "total_step": be.total_step,
        "pause_map_optim": be.pause_map_optim,
        "n_keyframes_added": system.n_keyframes_added,
        "width": system.width,
        "height": system.height,
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def restore_system(path, system) -> int:
    """Restore a SlamSystem saved by `save_checkpoint` (of either package)
    onto the system's device; returns the next frame index to process."""
    with np.load(path, allow_pickle=False) as data:
        d = {k: data[k] for k in data.files}
    be, fe = system.backend, system.frontend
    dev = be.device
    meta = json.loads(bytes(d["meta_json"]).decode())

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}

    be.gmap = gaussian_map_from_numpy(sub("gmap/"), dev)
    # the saved buffer may have grown beyond the configured capacity
    be.capacity = be.gmap.capacity
    adam = {f"{k}/{f}": v for k in ("mu", "nu") for f, v in sub(f"adam_{k}/").items()}
    adam["count"] = d["adam/count"]
    be.opt_state = adam_state_from_numpy(adam, dev)
    be.kf = keyframes_from_numpy(sub("kf/"), dev)
    be.kf_capacity = be.kf.capacity
    be.pose_opt = PoseAdamState(
        mu=torch.from_numpy(np.array(d["pose_opt/mu"], np.float32)).to(dev),
        nu=torch.from_numpy(np.array(d["pose_opt/nu"], np.float32)).to(dev),
        count=torch.from_numpy(np.array(d["pose_opt/count"], np.int32)).to(dev))
    be.key = torch.from_numpy(d["rng/key"].astype(np.int64))
    be.K = torch.from_numpy(np.array(d["K"], np.float32)).to(dev)
    be.kf_order = [int(s) for s in meta["kf_order"]]
    be.kf_frame_idx = {int(k): int(v) for k, v in meta["kf_frame_idx"].items()}
    be.frame_slot = {v: k for k, v in be.kf_frame_idx.items()}
    be.pose_graph = {int(k): set(v) for k, v in meta["pose_graph"].items()}
    be.total_step = int(meta["total_step"])
    be.pause_map_optim = bool(meta["pause_map_optim"])
    system.n_keyframes_added = int(meta["n_keyframes_added"])

    cam = Camera(K=torch.from_numpy(np.array(d["K"], np.float32)),
                 width=int(meta["width"]), height=int(meta["height"]))
    be.frames = _frames_from_arrays(d, "be_frames", cam)
    fe.frames = _frames_from_arrays(d, "fe_frames", cam)
    fe.track_times = [float(t) for t in d["fe/track_times"]]
    fe.losses = [float(x) for x in d["fe/losses"]]

    # the frontend's synced snapshot, made anew from the restored map
    be._refresh_sync_payload()
    fe.apply_sync(be.sync_payload())
    next_index = (max(f.index for f in fe.frames) + 1) if fe.frames else 0
    system.start_index = next_index
    return next_index


# ---------------- fused-runtime checkpoints ----------------


def state_leaves(state) -> dict:
    """{path: tensor} over a (nested) NamedTuple/dict state, with the JAX
    package's path strings (`jax.tree_util.keystr`): `.field` for a
    NamedTuple field, `['key']` for a dict key (dict keys sorted)."""
    out = {}

    def walk(x, prefix):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for name, v in zip(x._fields, x):
                walk(v, f"{prefix}.{name}")
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}['{k}']")
        else:
            out[prefix] = x

    walk(state, "")
    return out


def fused_state_from_numpy(d: dict, cfg, device: str | torch.device | None = None):
    """A FusedState on `device` from its leaves as numpy arrays, keyed as
    `save_fused_checkpoint` writes them (`leaf/<path>`; a JAX FusedState
    flattened with `tree_flatten_with_path` gives the same keys). `cfg`
    must describe the same run (max_frames, PGO): every leaf must be there
    with the shape the config gives, else ValueError names the leaf."""
    from gslam_tpu_torch.runtime.fused import HOST_FIELDS, FusedState, init_fused_state

    dev = resolve_device(device)

    def leaf(path):
        return np.asarray(d["leaf/" + path])

    cap = leaf(".gmap.means").shape[0]
    kf_cap, height, width = leaf(".kf.images").shape[:3]
    max_frames = leaf(".traj").shape[0]
    if max_frames != cfg.max_frames:
        raise ValueError(
            f"the state was taken with max_frames={max_frames} but the config says "
            f"{cfg.max_frames}; trajectory buffers would not line up")
    # the shapes and dtypes the config gives, with nothing allocated
    template = state_leaves(init_fused_state(cfg, cap, kf_cap, height, width,
                                             device="meta"))
    saved = {k[len("leaf/"):] for k in d if k.startswith("leaf/")}
    if saved != set(template):
        raise ValueError(
            "checkpoint/state field mismatch, saved with a different config or code "
            f"version (missing: {sorted(set(template) - saved)[:5]}, "
            f"unexpected: {sorted(saved - set(template))[:5]})")
    for path, t in template.items():
        if leaf(path).shape != tuple(t.shape):
            raise ValueError(f"leaf/{path}: checkpoint shape {leaf(path).shape} != "
                             f"template {tuple(t.shape)}: config mismatch")

    def sub(prefix):
        return {p[len(prefix):]: leaf(p) for p in template if p.startswith(prefix)}

    adam = {f"{k}/{f}": leaf(f".opt_state.{k}['{f}']")
            for k in ("mu", "nu") for f in TRAINABLE_FIELDS}
    adam["count"] = leaf(".opt_state.count")
    top = {}
    for name in FusedState._fields[4:]:
        t = template[f".{name}"]
        top[name] = torch.from_numpy(np.array(leaf(f".{name}"))).to(
            device="cpu" if name in HOST_FIELDS else dev, dtype=t.dtype)
    return FusedState(
        gmap=gaussian_map_from_numpy(sub(".gmap."), dev),
        opt_state=adam_state_from_numpy(adam, dev),
        kf=keyframes_from_numpy(sub(".kf."), dev),
        pose_opt=PoseAdamState(*(torch.from_numpy(np.array(leaf(f".pose_opt.{f}"))).to(
            device=dev, dtype=template[f".pose_opt.{f}"].dtype)
            for f in PoseAdamState._fields)),
        **top,
    )


def save_fused_checkpoint(path, state, frames_meta):
    """Snapshot the fused runtime: every FusedState leaf under its path,
    plus the frames' metadata (index, timestamp, gt pose). Resume with
    `FusedSlam.run(..., resume_from=path)`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {"leaf/" + p: v.detach().cpu().numpy() for p, v in state_leaves(state).items()}
    arrays["meta/format"] = np.asarray(FORMAT, np.int64)
    n = len(frames_meta)
    arrays["meta/indices"] = np.asarray([m[0] for m in frames_meta], np.int64)
    arrays["meta/timestamps"] = np.asarray(
        [m[1] if m[1] is not None else 0.0 for m in frames_meta], np.float64)
    gt = np.full((n, 4, 4), np.nan, np.float32)
    for i, m in enumerate(frames_meta):
        if m[2] is not None:
            gt[i] = np.asarray(m[2], np.float32)
    arrays["meta/gt_poses"] = gt
    arrays["meta/shape"] = np.asarray(
        [state.gmap.capacity, state.kf.capacity, state.kf.images.shape[1],
         state.kf.images.shape[2], state.traj.shape[0]], np.int64)
    np.savez_compressed(path, **arrays)


def load_fused_checkpoint(path, cfg, device: str | torch.device | None = None):
    """(FusedState, frames_meta) from `save_fused_checkpoint` output of
    either package. `cfg` must describe the same run."""
    with np.load(Path(path), allow_pickle=False) as data:
        d = {k: data[k] for k in data.files}
    if "meta/format" not in d:
        raise ValueError("checkpoint predates the path-keyed state format; re-create it")
    fmt = int(d["meta/format"])
    if fmt != FORMAT:
        raise ValueError(f"unknown fused checkpoint format {fmt}")
    state = fused_state_from_numpy(d, cfg, device)
    gt = d["meta/gt_poses"]
    frames_meta = [
        (int(d["meta/indices"][i]), float(d["meta/timestamps"][i]),
         None if np.isnan(gt[i]).any() else gt[i])
        for i in range(len(d["meta/indices"]))
    ]
    return state, frames_meta
