"""The control of each cell's check: the plain reference, computed with
TF32 on (the nearest precision below the float32 the configurations
state), put in the program's place. On the card, at the cell's own size
and on three seeds, the check must come out not correct.

As a script, it prints the readings the limits are set from, one JSON
line per run, the program's and the control's in one process:

    python3 -m benchmark.tests.test_benchmark_control <cell> <first seed> \\
        <program seeds> <control seeds>
"""

import gc
import json
import sys
import time

import pytest

from benchmark import harness, manifest

CELLS = ["qvga50k-track-igs", "vga1m-map", "qvga50k-track-gn"]
SEEDS = (4100000001, 4100000002, 4100000003)


def one_unit(cell, seed, device, control):
    """A run of one unit at the cell's own size (a window of 0 s)."""
    return harness.execute(cell, seed, 0.0, False, device, time.perf_counter(),
                           log=lambda s: None, control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, cuda_device):
    cell = manifest.Cell(manifest.load(), name)
    for seed in SEEDS:
        res = one_unit(cell, seed, cuda_device, control=True)
        assert not res["correct"], (seed, res["checks"])


def main(argv):
    import torch

    name, first, n_prog, n_ctrl = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    cell = manifest.Cell(manifest.load(), name)
    dev = torch.device("cuda")
    for i in range(n_prog + n_ctrl):
        gc.collect()
        torch.cuda.empty_cache()
        control = i >= n_prog
        seed = first + i
        res = one_unit(cell, seed, dev, control)
        print(json.dumps({"cell": name, "seed": seed, "control": control,
                          "correct": res["correct"], "failed": res["failed"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
