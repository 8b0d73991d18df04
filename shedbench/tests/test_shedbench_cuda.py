"""Each cell on the card, briefly: the command's last line says correct.
Skips without a card (decided inside the test)."""
import json
import subprocess
import sys

import pytest

from shedbench_tiny import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["shed_c128_t8", "cascade_c128_t8"])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "shedbench/run.py", "--workload", cell,
                        "--seed", "5", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["check"]
