"""Multi-device package: camera data parallelism and depth-band splat
sharding (sharding.py), and the sharded SLAM loop (slam.py), driven from
one process over a list of torch devices."""

from __future__ import annotations

import numpy as np

from gslam_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh, camera_dp_shardings, dp_mapping_train_step, make_mesh,
)


def _toy_inputs(n: int, width: int, height: int, device, seed: int = 0):
    """A toy map of n splats spread over the view frustum at depths 1.5-4
    and its intrinsics (the JAX package's dry-run inputs)."""
    import torch

    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy

    rng = np.random.default_rng(seed)
    fx = fy = 0.9 * width
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)
    z = rng.uniform(1.5, 4.0, n).astype(np.float32)
    u = rng.uniform(0, width, n).astype(np.float32)
    v = rng.uniform(0, height, n).astype(np.float32)
    gmap = gaussian_map_from_numpy(dict(
        means=np.stack([(u - width / 2) * z / fx, (v - height / 2) * z / fy, z], -1),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.05, 0.12, (n, 3)).astype(np.float32)),
        logit_opacities=np.full((n,), 2.0, np.float32),
        logit_colors=rng.normal(size=(n, 3)).astype(np.float32),
        log_uncertainties=np.zeros((n,), np.float32),
        alive=np.ones((n,), bool)), device=device)
    return gmap, torch.tensor(K, device=device)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The multi-device dry run: a camera-DP mapping step over an
    n-device mesh, a hybrid (2 bands x n/2 cameras) step when n >= 4 and
    even, and 4 frames of ShardedSlam (pose graph and densification on)
    over an n-band mesh, with the JAX package's toy sizes and asserts.
    `devices` defaults to the CUDA devices. Returns each part's result."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.mapping.optimizer import init_adam
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.parallel.sharding import (
        make_hybrid_mapping_step, make_hybrid_mesh, partition_by_depth, split_bands,
    )
    from gslam_tpu_torch.parallel.slam import ShardedSlam, ShardedSlamConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    out = {}
    width, height = 64, 48
    mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.first
    gmap, K = _toy_inputs(256, width, height, dev)
    C = n_devices  # one window camera per device
    rng = np.random.default_rng(0)
    gt = torch.tensor(rng.random((C, height, width, 3)).astype(np.float32), device=dev)
    eye = torch.eye(4, device=dev)
    cfg = MapConfig(render=RenderConfig(tile_capacity=64, tile_chunk=4))
    gmap, _opt, pose_vec = dp_mapping_train_step(
        gmap, init_adam(gmap), torch.zeros((C, 9), device=dev), eye.repeat(C, 1, 1), gt,
        torch.zeros((C, 2), device=dev), K.repeat(C, 1, 1), width, height, cfg, mesh=mesh)
    assert bool(torch.isfinite(gmap.means).all())
    out["camera_dp"] = (gmap, pose_vec)
    print(f"dryrun_multichip({n_devices}): camera-DP ok over {mesh}")

    if n_devices >= 4 and n_devices % 2 == 0:
        # depth bands along 'gauss', window cameras along 'cam'
        gmap2, K2 = _toy_inputs(256, width, height, dev)
        gmap2, opt2 = partition_by_depth(gmap2, eye, init_adam(gmap2))
        mesh2 = make_hybrid_mesh(2, n_devices // 2, devices=devices)
        bands = mesh2.axis_devices("gauss")
        C2 = n_devices // 2
        step = make_hybrid_mapping_step(mesh2, width, height, cfg)
        gt2 = torch.tensor(rng.random((C2, height, width, 3)).astype(np.float32), device=dev)
        b2, _o2, pv2 = step(split_bands(gmap2, bands), split_bands(opt2, bands),
                            torch.zeros((C2, 9), device=dev), eye.repeat(C2, 1, 1), gt2,
                            torch.zeros((C2, 2), device=dev), K2.repeat(C2, 1, 1))
        assert all(bool(torch.isfinite(b.means).all()) for b in b2)
        out["hybrid"] = (b2, pv2)
        print(f"dryrun_multichip({n_devices}): hybrid 2x{C2} (gauss x cam) ok over {mesh2}")

    # the full SLAM loop over an n-band mesh: banded tracking, insertion on
    # the joined buffer, banded mapping, the pose graph and densification
    rcfg = RenderConfig(tile_capacity=64, tile_chunk=8, pairs_per_gaussian=8)
    cap = 512 if 512 % n_devices == 0 else n_devices * (512 // n_devices + 1)
    slam = ShardedSlam(
        ShardedSlamConfig(
            tracking=TrackingConfig(warmup_steps=2, lbfgs_max_iter=6, lbfgs_max_eval=8,
                                    render=rcfg),
            # kf_m=1e-4 takes a keyframe every frame: the 4-frame walk then
            # holds >= 3 keyframes, the fewest for a non-consecutive IoU edge
            mapping=MapConfig(window_size=2, recent_window=1, num_iters_init=4,
                              num_iters_mapping=2, render=rcfg, enable_pgo=True,
                              densify_every=4, densify_max_new=32, kf_m=1e-4),
            init_n_new=300, kf_n_new=50, idle_iters=1),
        make_mesh(n_devices, axis="gauss", devices=devices), 48, 36, capacity=cap,
        kf_capacity=4, seed=0)
    ds = SyntheticDataset(seq_len=4, width=48, height=36, n_splats=200, seed=2,
                          motion_scale=0.008, device=dev)
    m = slam.run(ds)
    assert m["nonfinite_poses"] == 0 and m["health"] == 0, m
    # the slow overlapping walk must close at least one IoU loop edge
    assert m["loop_closures"] >= 1, m
    out["slam"] = m
    print(f"dryrun_multichip({n_devices}): full SLAM loop ok over {n_devices} bands: "
          f"L={m['L']} C={m['C']} live={m['live']} ate={m['ate']:.4f} "
          f"loop_closures={m['loop_closures']}")
    return out
