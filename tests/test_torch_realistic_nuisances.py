"""tests/test_realistic_motion.py's nuisance run on the port, on the CPU,
in its own file (one fused run per file). The raytraced room with sensor
noise, auto-exposure drift and mild defocus, with JAX's draws as in
test_torch_realistic.py: the depth-locked tracker and the per-frame exposure
estimate must hold ATE < 0.05 m; PSNR, measured against the degraded
frames, > 18 dB."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_realistic import NUISANCES, run_realistic  # noqa: E402


def test_tracks_under_photometric_nuisances(monkeypatch):
    _, m = run_realistic(monkeypatch, **NUISANCES)
    assert m["L"] == 10
    assert m["nonfinite_poses"] == 0, m
    assert m["diverged"] is False, m
    assert np.isfinite(m["ate"]) and m["ate"] < 0.05, m
    assert m["psnr"] > 18.0, m
