"""The RGB-D bootstrap held to the JAX package one mapping iteration at a
time: the CPU counterpart of chip_smoke.py's `bootstrap_stepped` record,
with the same comparison (chip_smoke.mapping_step_agreement) and tolerances.

Frame 0 of a 64x48 synthetic room (SyntheticDataset(seq_len=4, n_splats=400,
seed=3), tests/test_fused.py's small configuration with ground-truth depths)
is inserted once by the JAX package, as its slam_step inserts it, so no draw
needs replaying. JAX's public mapping_step then runs
the 40 bootstrap iterations; before each, its state is carried into the
port, which runs the same one mapping_step. JAX's tile lists and
projection come from compute_bins' program run beside the step, and its
gradients from value_and_grad of the window loss (the jitted step exposes
neither).

A freely running bootstrap is chaotic: both packages' opacities part by up
to ~0.1 under a 1e-7 change of the input image, and the port's as much when
only the isotropic loss's mean is rounded another way. Run as a script,
this file prints that self-gap for one package and each noise seed:

    PYTHONPATH=. python tests/test_torch_bootstrap_stepped.py --package torch|jax \
        --seed N [N ...] [--perturb image|iso-mean]
"""

import argparse
import importlib.util
import os
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
W, H, CAP, KF_CAP = 64, 48, 2048, 8
SCENE = dict(seq_len=4, width=W, height=H, n_splats=400, seed=3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(package):
    """The scene's configuration in RGB-D mode: tests/test_fused.py's small
    one ("jax"), or chip_smoke.py's copy of it ("torch")."""
    cs = _chip_smoke()
    if package == "jax":
        from test_fused import small_fused_cfg

        return cs.with_gt_depths(small_fused_cfg())
    return cs.with_gt_depths(cs.slam_small_cfg())


def _jax_programs():
    import jax
    import jax.numpy as jnp

    from gslam_tpu.core.transforms import PoseDelta, pose_matrix
    from gslam_tpu.mapping import backend_ops as jb
    from gslam_tpu.ops.binning import bin_gaussians
    from gslam_tpu.ops.projection import project_gaussians

    grads = jax.jit(jax.value_and_grad(jb._window_loss, argnums=(0, 2, 3), has_aux=True),
                    static_argnames=("width", "height", "cfg"))

    @partial(jax.jit, static_argnames=("width", "height", "cfg"))
    def bins(gmap, pose_base, pose_vec, K, width, height, cfg):
        """compute_bins' program (vmap over the cameras, the projection
        materialized before binning), the projection kept."""
        r, n, ts = cfg.render, gmap.capacity, cfg.render.tile_size
        vms = pose_matrix(PoseDelta(pose_base, pose_vec[:, :6], pose_vec[:, 6:9]))

        def one(vm):
            proj = project_gaussians(gmap.means, gmap.quats, jnp.exp(gmap.log_scales), vm, K,
                                     width, height, near=r.near, far=r.far, eps2d=r.eps2d,
                                     radius_clip=r.radius_clip, alive=gmap.alive)
            m2d, radii, depths, valid = jax.lax.optimization_barrier(
                (proj.means2d, proj.radii, proj.depths, proj.valid))
            return proj, bin_gaussians(m2d, radii, depths, valid, ts, -(-width // ts),
                                       -(-height // ts), int(r.pairs_per_gaussian * n),
                                       r.tile_capacity, r.max_span)

        return jax.vmap(one)(vms)

    return grads, bins


def _jax_step(programs, g, o, kf, po, widx, wmask, K, cfg):
    """JAX's mapping_step as a step record (chip_smoke.port_step's keys)."""
    import jax.numpy as jnp

    from gslam_tpu.mapping import backend_ops as jb

    grads, bins = programs
    Wn = widx.shape[0]
    safe = jnp.where(wmask, widx, 0)
    pose_vec = jnp.concatenate([kf.d_rot6[safe], kf.d_t[safe]], -1)
    _, (g_map, g_pose, _) = grads(
        g.trainable(), g, pose_vec, jnp.zeros((Wn, g.capacity, 2)), kf.pose_base[safe],
        kf.images[safe], kf.gt_depths[safe], kf.exposures[safe], wmask,
        jnp.tile(K[None], (Wn, 1, 1)), width=W, height=H, cfg=cfg)
    proj, b = bins(g, kf.pose_base[safe], pose_vec, K, width=W, height=H, cfg=cfg)
    out = jb.mapping_step(g, o, kf, po, widx, wmask, K, W, H, cfg)
    g2, o2, _, _, aux = out
    rec = dict(total_loss=float(aux.total_loss), photometric_loss=float(aux.photometric_loss),
               cam_mask=np.asarray(wmask), means2d=np.asarray(proj.means2d),
               radii_proj=np.asarray(proj.radii), depths=np.asarray(proj.depths),
               conics=np.asarray(proj.conics), valid=np.asarray(proj.valid),
               tile_gauss=np.asarray(b.tile_gauss), tile_mask=np.asarray(b.tile_mask),
               n_pairs=np.asarray(b.n_pairs), radii=np.asarray(aux.radii),
               n_touched=np.asarray(aux.n_touched),
               decay=(np.asarray(aux.radii > 0).sum(0) > 1) & np.asarray(g.alive),
               g_pose=np.asarray(g_pose))
    for f, v in g_map.items():
        rec[f"g/{f}"], rec[f"mu/{f}"] = np.asarray(v), np.asarray(o2.mu[f])
        rec[f"p/{f}"] = np.asarray(getattr(g2, f))
    return rec, out


def _jax_bootstrap(ds, cfg):
    """Frame 0 as the JAX package's slam_step inserts it (its draws from
    PRNGKey(0), the identity pose, the ground-truth depth), through the
    jitted insert_from_depthmap alone: the map, its Adam state, the
    keyframe store and the pose Adam."""
    import jax
    import jax.numpy as jnp

    from gslam_tpu.mapping.backend_ops import init_pose_adam
    from gslam_tpu.mapping.gaussians import empty_map
    from gslam_tpu.mapping.insertion import insert_from_depthmap
    from gslam_tpu.mapping.keyframes import add_keyframe, empty_keyframes
    from gslam_tpu.mapping.optimizer import init_adam

    k_a, k_b, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    mock = (1.0 + (jax.random.normal(k_a, (H, W)) - 0.5) * 0.3) * cfg.mapping.initial_scale
    image, depth, eye = jnp.asarray(ds.images[0]), jnp.asarray(ds.depths[0]), jnp.eye(4)
    gmap = empty_map(CAP)
    r = insert_from_depthmap(k_b, gmap, init_adam(gmap), mock, jnp.full((H, W), 0.01), image,
                             ds.camera.K, eye, n_new=cfg.init_n_new, frame_index=0,
                             cfg=cfg.insertion, gt_depthmap=depth)
    kf = add_keyframe(empty_keyframes(KF_CAP, H, W), 0, image, eye, jnp.zeros(2), 0,
                      gt_depth=depth)
    return r.gmap, r.opt_state, kf, init_pose_adam(KF_CAP)


def _to_port(g, o, kf, po):
    from gslam_tpu_torch.mapping.backend_ops import PoseAdamState
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.mapping.keyframes import keyframes_from_numpy
    from gslam_tpu_torch.mapping.optimizer import adam_state_from_numpy

    adam = {f"{k}/{f}": np.asarray(v) for k in ("mu", "nu") for f, v in getattr(o, k).items()}
    return (gaussian_map_from_numpy({f: np.asarray(getattr(g, f)) for f in g._fields}, "cpu"),
            adam_state_from_numpy({**adam, "count": np.asarray(o.count)}, "cpu"),
            keyframes_from_numpy({f: np.asarray(x) for f, x in zip(kf._fields, kf)}, "cpu"),
            PoseAdamState(*(torch.from_numpy(np.array(x)) for x in po)))


def test_bootstrap_steps_match_jax():
    """Each of the 40 iterations from JAX's state: no output parts beyond
    chip_smoke.STEP_TOL once the ties are taken out, and the ties are
    printed. On this scene every inserted splat starts exactly isotropic,
    so the isotropic loss sits at its kink and the two packages' float32
    means land on either side of it (iso_flips), and a footprint or an
    alpha lands within rounding of its threshold in a few iterations."""
    import jax.numpy as jnp

    from gslam_tpu.io.synthetic import SyntheticDataset

    cs = _chip_smoke()
    ds = SyntheticDataset(**SCENE)
    g, o, kf, po = _jax_bootstrap(ds, _cfg("jax"))
    assert int(g.alive.sum()) == 400
    jcfg, tcfg = _cfg("jax").mapping, _cfg("torch").mapping
    # frame 0's window: the bootstrap keyframe and three padded slots
    widx, wmask = jnp.zeros(4, jnp.int32), jnp.asarray([True, False, False, False])
    targs = (torch.zeros(4, dtype=torch.int64), torch.tensor([True, False, False, False]),
             torch.from_numpy(np.array(ds.camera.K)), W, H)
    programs = _jax_programs()
    records = []
    for _ in range(jcfg.num_iters_init):
        shared = dict(log_scales=np.asarray(g.log_scales), alive=np.asarray(g.alive))
        port = (*_to_port(g, o, kf, po), *targs)
        b, (g, o, kf, po, _) = _jax_step(programs, g, o, kf, po, widx, wmask, ds.camera.K,
                                         jcfg)
        a = cs.port_step(port, tcfg)[0]

        def band(port=port):
            return [cs.port_step(port, c)[0] for c in cs.alpha_band_cfgs(tcfg)]

        records.append(cs.mapping_step_agreement(a, b, band, shared, tcfg, W, H))
    summary = cs.stepped_summary(records)
    print(summary)
    for k, r in enumerate(records):
        if r["binning_ties"] or r["alpha_band_entries"]:
            print(k, r["binning_ties"], r["alpha_band_entries"])
    parted = [(k, r["faults"]) for k, r in enumerate(records) if r["faults"]]
    assert summary["first_part"] is None, (parted, records[parted[0][0]])
    assert len(records) == 40 and records[0]["iso_splats"] == 400  # every insert isotropic


def _iso_mean_by_multiply(log_scales, visible):
    """The isotropic loss with its mean rounded as sum * float32(1/3)."""
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32)
    mean_scale = torch.exp((torch.sum(log_scales, dim=1, keepdim=True) * third).detach())
    dev = torch.abs(torch.exp(log_scales) - mean_scale)
    return torch.sum(torch.where(visible[:, None], dev, 0.0))


def _free_run(package, noise_seed, perturb="image"):
    """Frame 0's bootstrap (40 iterations) run clean and perturbed: the
    image scaled by 1 + 1e-7 N(0, 1) ("image"), or, in the port, the
    isotropic loss's mean rounded as sum * (1/3) ("iso-mean"). The live
    counts of both runs and the largest opacity gap over the slots both
    keep."""
    rng = np.random.default_rng(noise_seed)
    runs = []
    if package == "jax":
        import jax.numpy as jnp

        from gslam_tpu.io.synthetic import SyntheticDataset
        from gslam_tpu.runtime import fused as jf

        ds, cfg = SyntheticDataset(**SCENE), _cfg("jax")
        img = np.asarray(ds.images[0])
        for scale in (1.0, 1.0 + 1e-7 * rng.standard_normal(img.shape)):
            s = jf.slam_step(jf.init_fused_state(cfg, CAP, KF_CAP, H, W, seed=0),
                             jnp.asarray((img * scale).astype(np.float32)),
                             jnp.asarray(ds.depths[0]), ds.camera.K, W, H, cfg)
            runs.append((np.asarray(s.gmap.alive), np.asarray(s.gmap.logit_opacities)))
    else:
        from gslam_tpu_torch.io.synthetic import SyntheticDataset
        from gslam_tpu_torch.mapping import backend_ops
        from gslam_tpu_torch.runtime import fused as tf

        ds, cfg = SyntheticDataset(**SCENE, device="cpu"), _cfg("torch")
        img = np.asarray(ds.images[0])
        noise = 1e-7 * rng.standard_normal(img.shape) if perturb == "image" else 0.0
        iso = backend_ops.isotropic_scale_loss
        for k, scale in enumerate((1.0, 1.0 + noise)):
            if perturb == "iso-mean" and k:
                backend_ops.isotropic_scale_loss = _iso_mean_by_multiply
            try:
                s = tf.slam_step(tf.init_fused_state(cfg, CAP, KF_CAP, H, W, seed=0,
                                                     device="cpu"),
                                 (img * scale).astype(np.float32), ds.depths[0], ds.camera.K,
                                 W, H, cfg)
            finally:
                backend_ops.isotropic_scale_loss = iso
            runs.append((s.gmap.alive.numpy(), s.gmap.logit_opacities.numpy()))
    (a0, l0), (a1, l1) = runs
    both = a0 & a1
    gap = np.abs(1 / (1 + np.exp(-l0)) - 1 / (1 + np.exp(-l1)))[both]
    return dict(package=package, perturb=perturb, noise_seed=noise_seed,
                live=[int(a0.sum()), int(a1.sum())], max_opacity_gap=float(gap.max()),
                slots_over_1e3=int((gap > 1e-3).sum()))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("torch", "jax"), required=True)
    p.add_argument("--seed", type=int, nargs="+", default=[1])
    p.add_argument("--perturb", choices=("image", "iso-mean"), default="image",
                   help="iso-mean: the port only; the seed is then unused")
    args = p.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    for seed in args.seed:
        print(_free_run(args.package, seed, args.perturb), flush=True)
