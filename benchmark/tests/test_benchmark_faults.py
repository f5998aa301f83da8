"""The check catches a broken timed path: each cell's run on the CPU at a
cut size (the harness's look for a card skipped), once with each fault the
cell can have planted in the program underneath, must come out not
correct. The faults: a step that returns its state unchanged; half of the
batch (pixels, or window cameras) left out with the mean taken over the
rest; half of the pixels left out of the tracker's gradient alone; an
answer altered where it is produced. One card holds every cell,
so no exchange between cards can be left out."""

import importlib

import pytest

from benchmark.tests.test_benchmark_drivers import cut, run

torch = pytest.importorskip("torch")
track = importlib.import_module("gslam_tpu_torch.tracking.track")
backend_ops = importlib.import_module("gslam_tpu_torch.mapping.backend_ops")


def _track_unchanged(monkeypatch):
    orig = track.track_frame

    def frozen(gmap, base_pose, init_exposure, *args, **kw):
        r = orig(gmap, base_pose, init_exposure, *args, **kw)
        return r._replace(pose=base_pose.clone(), exposure=init_exposure.clone())

    monkeypatch.setattr(track, "track_frame", frozen)


def _track_altered(monkeypatch):
    orig = track.track_frame

    def moved(*args, **kw):
        r = orig(*args, **kw)
        pose = r.pose.clone()
        pose[0, 3] += 0.005
        return r._replace(pose=pose)

    monkeypatch.setattr(track, "track_frame", moved)


def _track_half_pixels(monkeypatch):
    orig = track.tracking_photometric

    def half(rendered, gt, betas, kind="active-nerf"):
        h = rendered.shape[0] // 2
        return orig(rendered[:h], gt[:h], betas[:h], kind)

    monkeypatch.setattr(track, "tracking_photometric", half)
    loss = track.GaussNewtonProblem.loss

    def gn_half(self, err, derr, beta, alpha):
        n = beta.shape[0] // 2
        return loss(self, err[: 3 * n], derr, beta[:n], alpha[:n])

    monkeypatch.setattr(track.GaussNewtonProblem, "loss", gn_half)


def _track_half_pixels_backward(monkeypatch):
    """Half of the pixels left out of the gradient alone: the objective's
    value is whole, so the loss and, on noise-free frames, the pose can
    stay where sound runs read them."""
    orig = track.tracking_photometric

    def half(rendered, gt, betas, kind="active-nerf"):
        h = rendered.shape[0] // 2
        return orig(torch.cat([rendered[:h], rendered[h:].detach()]), gt,
                    torch.cat([betas[:h], betas[h:].detach()]), kind)

    monkeypatch.setattr(track, "tracking_photometric", half)
    residuals = track.GaussNewtonProblem.residuals

    def gn_half(self, x):
        err, derr, beta, alpha = residuals(self, x)
        n = err.shape[0] // 2
        return torch.cat([err[:n], err[n:].detach()]), derr, beta, alpha

    monkeypatch.setattr(track.GaussNewtonProblem, "residuals", gn_half)


def _map_unchanged(monkeypatch):
    orig = backend_ops.mapping_step

    def frozen(gmap, opt_state, kf, pose_opt, *args, **kw):
        aux = orig(gmap, opt_state, kf, pose_opt, *args, **kw)[4]
        return gmap, opt_state, kf, pose_opt, aux

    monkeypatch.setattr(backend_ops, "mapping_step", frozen)


def _map_altered(monkeypatch):
    orig = backend_ops.mapping_step

    def moved(*args, **kw):
        g, o, kf, p, aux = orig(*args, **kw)
        return g._replace(means=g.means + 1e-3), o, kf, p, aux

    monkeypatch.setattr(backend_ops, "mapping_step", moved)


def _map_half_cameras(monkeypatch):
    orig = backend_ops.mapping_photometric

    def half(rendered, gt, betas, active_gs=True, cam_mask=None):
        mask = cam_mask.clone()
        mask[mask.shape[0] // 2:] = False
        return orig(rendered, gt, betas, active_gs=active_gs, cam_mask=mask)

    monkeypatch.setattr(backend_ops, "mapping_photometric", half)


FAULTS = {
    "qvga50k-track-igs": (_track_unchanged, _track_half_pixels, _track_half_pixels_backward,
                          _track_altered),
    "qvga50k-track-gn": (_track_unchanged, _track_half_pixels, _track_half_pixels_backward,
                         _track_altered),
    "vga1m-map": (_map_unchanged, _map_half_cameras, _map_altered),
}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cut(name))
    assert not res["correct"], res["checks"]


def main(argv):
    """Readings of one fault at the cell's own size on the card:
    python3 -m benchmark.tests.test_benchmark_faults <cell> <fault> <first seed> <seeds> <s>"""
    import json
    import time

    from benchmark import harness, manifest

    name, fault, first, n, seconds = argv[0], argv[1], int(argv[2]), int(argv[3]), float(argv[4])
    plant = {f.__name__: f for f in FAULTS[name]}[fault]
    for seed in range(first, first + n):
        mp = pytest.MonkeyPatch()
        plant(mp)
        try:
            res = harness.execute(manifest.Cell(manifest.load(), name), seed, seconds, False,
                                  torch.device("cuda"), time.perf_counter(), log=lambda s: None)
        finally:
            mp.undo()
        print(json.dumps({"cell": name, "fault": fault, "seed": seed, "correct": res["correct"],
                          "failed": res["failed"],
                          "attempted": res["attempted"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
