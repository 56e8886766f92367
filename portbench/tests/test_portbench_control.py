"""On the card: the control (the reference in the configuration's control
precision, put in the program's place) comes out not correct at each
cell's own size, while the program, on the same seed and inputs, is
correct. A 30 s window at the cell's own load (a stream window then holds its
summary, a qa window three greedy answers); every cell. Run:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import pytest

from portbench import manifest
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's hand-written kernels")
    from portbench import run

    run._environment(ROOT)
    out = run.run_cell(workload, 2 ** 31 + 77, 30.0, False, torch.device("cuda", 0),
                       control=True)
    assert out["correct"], out["checks"]
    assert any(r["control"] > r["limit"] for r in out["checks"].values()), out["checks"]
