"""The port's public surface: every name that a gslam_tpu/<sub>/__init__.py
binds imports from gslam_tpu_torch.<sub> (the JAX files are read with ast,
not imported), the pose helpers that surface adds against the JAX package,
the optimizer entries, and an import of the surface that builds no kernel."""

import ast
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("core", "eval", "io", "mapping", "ops", "opt", "parallel", "runtime",
               "tracking", "viz")


def _bound_names(sub):
    """The names gslam_tpu/<sub>/__init__.py binds at module level."""
    names = set()
    for node in ast.parse((ROOT / "gslam_tpu" / sub / "__init__.py").read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names - {"annotations"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    names = _bound_names(sub)
    assert names, sub
    module = importlib.import_module(f"gslam_tpu_torch.{sub}")
    assert sorted(n for n in names if not hasattr(module, n)) == []


def test_pose_delta_helpers_match_jax():
    """identity_pose_delta and rebase_pose on a batch of seeded poses
    (tests/test_transforms.py's cases, batched), within 1e-6."""
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from gslam_tpu.core import transforms as jt
    from gslam_tpu_torch.core import transforms as tt

    rng = np.random.default_rng(7)
    base = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    base[:, :3, :3] = Rotation.random(5, random_state=3).as_matrix()
    base[:, :3, 3] = rng.normal(size=(5, 3))
    d6 = (rng.normal(size=(5, 6)) * 0.1).astype(np.float32)
    dt = (rng.normal(size=(5, 3)) * 0.1).astype(np.float32)

    def same(tp, jp):
        for f, a, b in zip(jp._fields, tp, jp):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, f
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f)

    same(tt.identity_pose_delta(torch.from_numpy(base)),
         jt.identity_pose_delta(jnp.asarray(base)))
    same(tt.identity_pose_delta(device="cpu"), jt.identity_pose_delta())
    tp = tt.PoseDelta(*(torch.from_numpy(x) for x in (base, d6, dt)))
    jp = jt.PoseDelta(*(jnp.asarray(x) for x in (base, d6, dt)))
    same(tt.rebase_pose(tp), jt.rebase_pose(jp))
    # folding the delta keeps the pose
    np.testing.assert_allclose(tt.pose_matrix(tt.rebase_pose(tp)).numpy(),
                               tt.pose_matrix(tp).numpy(), atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tt.identity_pose_delta()  # CUDA unless a device is named


def test_optimizer_entries_are_the_eager_loops():
    from gslam_tpu_torch import opt

    # opt/__init__ binds `lbfgs` to the entry point, as the JAX package's does
    lbfgs = importlib.import_module("gslam_tpu_torch.opt.lbfgs")
    compact = importlib.import_module("gslam_tpu_torch.opt.lbfgs_compact")
    assert opt.lbfgs is lbfgs.lbfgs is lbfgs.lbfgs_impl
    assert compact.warmup_lbfgs is compact.warmup_lbfgs_impl


def test_importing_the_surface_builds_no_kernel():
    """A fresh interpreter imports gslam_tpu_torch.ops and .runtime with
    ops/cuda_build's nvcc_path and load replaced by functions that raise."""
    code = textwrap.dedent(f"""
        import importlib.util, sys
        sys.path.insert(0, {str(ROOT)!r})
        name = "gslam_tpu_torch.ops.cuda_build"
        spec = importlib.util.spec_from_file_location(
            name, {str(ROOT / "gslam_tpu_torch" / "ops" / "cuda_build.py")!r})
        cb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cb)

        def refuse(*a, **kw):
            raise AssertionError("a CUDA build at import")

        cb.nvcc_path = cb.load = refuse
        sys.modules[name] = cb
        import gslam_tpu_torch.ops
        import gslam_tpu_torch.runtime
        assert gslam_tpu_torch.ops.blend.cuda_build is cb
        print("imported")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.split() == ["imported"], out.stderr
