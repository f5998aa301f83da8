"""bench_torch.py, the port's counterpart of bench.py, on the CPU at cut
sizes: its points are bench.py's (the map fields and the mapping point
exactly, the tracking point's ground truth within 1e-5 of JAX's render), its
headline is chosen as bench.py's, each section emits bench.py's parts and
keys, and a failed section makes the run exit non-zero after the summary.

bench.py is read through test_torch_scripts._load_jax_script; its sections
are never run here (they are full-size JAX programs)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

import bench_torch  # noqa: E402  (puts scripts/ on sys.path)
import bench_1m_torch  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_scripts import _load_jax_script  # noqa: E402

j_bench = _load_jax_script("bench", ROOT)

CPU = "cpu"
MAP_FIELDS = ("means", "quats", "log_scales", "logit_opacities", "logit_colors",
              "log_uncertainties", "alive")
ONEM_KW = dict(scale_lo=0.002, scale_hi=0.008, z_hi=6.0, opacity=0.5)  # bench.py:358-359


def _assert_fields_equal(port_fields, jax_map):
    for f in MAP_FIELDS:
        np.testing.assert_array_equal(np.asarray(port_fields[f]), np.asarray(getattr(jax_map, f)),
                                      err_msg=f)


@pytest.mark.parametrize("w, h, fx, kw", [(320, 240, 280.0, {}), (640, 480, 560.0, ONEM_KW)],
                         ids=["tracking_mapping", "onemillion"])
def test_map_fields_equal_bench_py(w, h, fx, kw):
    """chip_smoke.make_map_fields, given the view's width, height and fx,
    draws bench.py's `_make_map` exactly (seed 0, 3,000 slots, 2,000 live)."""
    fields = chip_smoke.make_map_fields(3000, 2000, np.random.default_rng(0), width=w,
                                        height=h, fx=fx, **kw)
    jmap = j_bench._make_map(3000, 2000, w, h, fx, np.random.default_rng(0), **kw)
    _assert_fields_equal(fields, jmap)


def test_onemillion_point_equals_bench_py():
    """bench_1m_torch.point_arrays with its colors x1.5 (onemillion_arrays)
    is bench.py's 1M map at a cut capacity (4,096 slots, 3,000 live), and
    the 12 keyframe images drawn after it are bench.py's."""
    fields, images = bench_torch.onemillion_arrays(4096, 3000)
    rng = np.random.default_rng(0)
    jmap = j_bench._make_map(4096, 3000, 640, 480, 560.0, rng, **ONEM_KW)
    _assert_fields_equal(fields, jmap)
    for img in images:
        np.testing.assert_array_equal(img, rng.random((480, 640, 3)).astype(np.float32))


def test_mapping_point_equals_bench_py():
    """bench_torch.mapping_point is bench.py's `_mapping_op_point()` at full
    size: the map fields, the 12 keyframe images and poses (the whole
    32-slot store), the window, K and the configs (every field the port's
    configs share with JAX's)."""
    import dataclasses

    (jmap, _, jkf, _, jwidx, jwmask, jK, jw, jh, jcfg) = j_bench._mapping_op_point()
    gmap, _opt, kf, _pose_opt, widx, wmask, K, cfg = bench_torch.mapping_point(device=CPU)
    _assert_fields_equal({f: getattr(gmap, f).numpy() for f in MAP_FIELDS}, jmap)
    for f in kf._fields:
        np.testing.assert_array_equal(getattr(kf, f).numpy(), np.asarray(getattr(jkf, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(widx.numpy(), np.asarray(jwidx))
    np.testing.assert_array_equal(wmask.numpy(), np.asarray(jwmask))
    np.testing.assert_array_equal(K.numpy(), np.asarray(jK))
    assert (chip_smoke.W, chip_smoke.H) == (jw, jh)
    port_cfg = dataclasses.asdict(cfg)
    jax_cfg = dataclasses.asdict(jcfg)
    port_render, jax_render = port_cfg.pop("render"), jax_cfg.pop("render")
    assert port_cfg == jax_cfg
    assert port_render == {k: jax_render[k] for k in port_render}


def dataclasses_subset(port_cfg, jax_cfg):
    """Every field of the port's config equals JAX's field of that name."""
    import dataclasses

    return all(getattr(jax_cfg, f.name) == getattr(port_cfg, f.name)
               for f in dataclasses.fields(port_cfg))


def test_tracking_point_matches_jax_render():
    """A cut tracking point (200 splats, 32x24, fx 28, 3 frames) built as
    bench.py:106-123 builds it: the chained poses and the generic render of
    all of them, clipped, within 1e-5 of the JAX package's."""
    from gslam_tpu.core.transforms import se3_exp
    from gslam_tpu.ops.rasterize import RenderConfig, render

    n, w, h, fx, n_frames = 200, 32, 24, 28.0, 3
    _gmap, _K, tcfg, poses, gts = bench_torch.tracking_point(n, w, h, fx, n_frames, device=CPU)
    rng = np.random.default_rng(0)
    jmap = j_bench._make_map(n, n, w, h, fx, rng)
    jK = jnp.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], jnp.float32)
    xis = rng.normal(scale=0.004, size=(n_frames, 6)).astype(np.float32)
    jposes, cur = [], jnp.eye(4)
    for i in range(n_frames):
        cur = se3_exp(jnp.asarray(xis[i])) @ cur
        jposes.append(cur)
    jposes = jnp.stack(jposes)
    rcfg = RenderConfig(tile_capacity=512, tile_chunk=50, pairs_per_gaussian=8)
    assert dataclasses_subset(tcfg.render, rcfg)
    jout = render(**jmap.render_kwargs(), viewmats=jposes, Ks=jnp.tile(jK[None], (n_frames, 1, 1)),
                  width=w, height=h, cfg=rcfg)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-5)
    np.testing.assert_allclose(gts.numpy(), np.asarray(jnp.clip(jout.rgb, 0.0, 1.0)), atol=1e-5)
    assert float(gts.std()) > 0.01  # the frames show the map


@pytest.mark.parametrize("parts", [
    {"tracking_device": {"device_fps_lower_bound": 0.41},
     "tracking_device_gn": {"device_fps_lower_bound": 1.7}, "mapping": {"mapping_iter_ms": 60.0}},
    {"tracking_device": {"device_fps_lower_bound": 0.41}, "errors": ["tracking: timeout"]},
    {},
], ids=["gn", "no_gn", "empty"])
def test_summarize_picks_bench_py_headline(parts):
    """The same parts give bench.py's headline: GN pyr3x8 when it landed,
    else the full budget, vs_baseline = fps / 30; the metric says it is wall
    time with the host included."""
    ours, theirs = bench_torch._summarize(parts), j_bench._summarize(parts)
    for key in ("value", "unit", "vs_baseline", "detail"):
        assert ours[key] == theirs[key], key
    assert ("GN pyr3x8" in ours["metric"]) == ("GN pyr3x8" in theirs["metric"])
    assert "wall time with the host included" in ours["metric"]


def test_bench_py_keys_are_bench_pys():
    """bench_torch.BENCH_PY_KEYS lists the keys of every part bench.py emits
    (its `_emit` calls, read with ast; a part named by marginal_rate's
    argument takes that call's dict), and SECTION_PARTS names its parts."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Name)]
    via_marginal = [c.args[1].value for c in calls if c.func.id == "marginal_rate"]
    keys = {}
    for c in calls:
        if c.func.id != "_emit" or not isinstance(c.args[1], ast.Dict):
            continue
        names = [k.value for k in c.args[1].keys]
        if names == ["error"]:  # bench.py's fallbacks, which the port does not have
            continue
        parts = [c.args[0].value] if isinstance(c.args[0], ast.Constant) else via_marginal
        for part in parts:
            keys[part] = tuple(names)
    assert keys == bench_torch.BENCH_PY_KEYS
    assert sorted(p for ps in bench_torch.SECTION_PARTS.values() for p in ps) == sorted(keys)


SMALL_RENDER = dict(tile_capacity=64, tile_chunk=50, pairs_per_gaussian=8)


def _cut(section):
    """A cut size of each section: a few hundred splats, 3 frames at 32x24,
    marginal lengths 1 against 2, a short tracker budget."""
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    small = dict(width=32, height=24, fx=28.0)
    return {
        "tracking": dict(small, n_splats=200, n_frames=3,
                         marginal=dict.fromkeys(bench_torch.TRACK_MARGINAL, (1, 2)),
                         tcfg=TrackingConfig(render=RenderConfig(**SMALL_RENDER), warmup_steps=2,
                                             lbfgs_max_eval=10, lbfgs_max_iter=10)),
        "mapping": dict(small, cap=2048, n_live=1500, iters=2, marginal=(1, 2),
                        render=RenderConfig(**SMALL_RENDER)),
        "onemillion": dict(small, cap=2048, n_live=1500, iters=2, render_marginal=(1, 2),
                           step_marginal=(1, 2)),
    }[section]


@pytest.mark.parametrize("section", list(bench_torch.SECTIONS))
def test_section_emits_bench_py_parts_on_the_cpu(section, capsys):
    """Each section at a cut size on the CPU prints and returns bench.py's
    parts with bench.py's keys, host-clock times, finite numbers, no blend
    launch (plain versions on the CPU) and no device figure."""
    capsys.readouterr()
    parts = bench_torch.SECTIONS[section](device=CPU, **_cut(section))
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [p.pop("part") for p in printed] == list(bench_torch.SECTION_PARTS[section])
    assert printed == [json.loads(json.dumps(parts[p]))
                       for p in bench_torch.SECTION_PARTS[section]]
    for name, part in parts.items():
        assert set(bench_torch.BENCH_PY_KEYS[name]) <= set(part), name
        assert part["timer"] == "host_clock" and part["platform"] == "cpu", name
        assert bench_torch.finite(part), name
        assert part.get("device_busy_ms") is None and part["max_memory_allocated_bytes"] is None
        for key, launches in part.items():
            if key.startswith("blend_launches"):
                assert set(launches.values()) == {0}, (name, key)
    if section == "tracking":
        assert parts["tracking"]["n_frames"] == 3
        assert all(n > 0 for n in parts["tracking"]["n_evals_per_frame"])
        assert parts["tracking"]["final_pose_err_m"] < 0.05
        assert parts["tracking_device_converged"]["max_evals"] == 36
        assert parts["tracking_device_gn"]["tracker"]["method"] == "gn"


def test_main_exits_nonzero_after_the_summary_when_sections_fail(monkeypatch, tmp_path, capsys):
    """Each section raises in its process (a CUDA device named on a host
    without one): main prints the summary line with one error per section,
    writes it to latest_torch.json and returns 1."""
    if torch.cuda.is_available():
        pytest.skip("the sections fail here only because the host has no CUDA device")
    monkeypatch.setattr(bench_1m_torch, "nvidia_smi", lambda: "no card")
    monkeypatch.setattr(bench_torch, "LATEST", tmp_path / "latest_torch.json")
    capsys.readouterr()
    assert bench_torch.main(["--device", "cuda:0"]) == 1
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    errors = summary["detail"]["errors"]
    assert [e.split(":")[0] for e in errors] == list(bench_torch.SECTIONS)
    assert all("exit code 1" in e for e in errors), errors
    assert summary["value"] == 0 and summary["detail"]["nvidia_smi"] == "no card"
    assert json.loads((tmp_path / "latest_torch.json").read_text()) == summary
