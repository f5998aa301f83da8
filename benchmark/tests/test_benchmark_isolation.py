"""Nothing that the benchmark's command or its reference reaches imports
jax, jaxlib, flax or the JAX package gslam_tpu, compared by whole top-level
module name (gslam_tpu_torch begins with gslam_tpu); the reference and the
traffic generator also import nothing of gslam_tpu_torch."""

import ast
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness, manifest

BENCH = manifest.ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "gslam_tpu"}
STANDALONE = ("reference", "traffic")  # the yardstick: no program code


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import_in_source(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, f"{path.name} imports {tops & FORBIDDEN}"
    if path.relative_to(BENCH).parts[0] in STANDALONE:
        assert "gslam_tpu_torch" not in tops, f"{path.name} imports the program"


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_command_reaches_no_jax():
    """Every module the command loads: the harness, each cell's driver and
    metric readers, and the program modules the drivers call."""
    tops = _modules_after("""
        import sys
        from benchmark import harness, manifest
        bench = manifest.load()
        for w in bench["workloads"]:
            cell = manifest.Cell(bench, w["name"])
            cell.driver()
            for m in cell.end_to_end + cell.per_layer:
                cell.reader(m["name"])
        import gslam_tpu_torch.tracking.track, gslam_tpu_torch.mapping.backend_ops
        import gslam_tpu_torch.mapping.keyframes, gslam_tpu_torch.mapping.optimizer
        import gslam_tpu_torch.ops.rasterize, gslam_tpu_torch.ops.blend
        print(" ".join(sorted({n.split(".")[0] for n in sys.modules})))
    """)
    assert "gslam_tpu_torch" in tops and "benchmark" in tops
    assert not tops & FORBIDDEN


def test_reference_reaches_nothing_of_the_program():
    tops = _modules_after("""
        import sys
        import benchmark.reference.splats, benchmark.traffic.generate
        print(" ".join(sorted({n.split(".")[0] for n in sys.modules})))
    """)
    assert not tops & (FORBIDDEN | {"gslam_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gslam_tpu_torch_probe.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "gslam_tpu.probe", sys)
    assert "gslam_tpu" in harness.forbidden_modules()
