"""Each cell run on the card through ``run.py`` (a short window): the run
ends with ``correct`` true and its end-to-end metrics. Marked ``cuda``;
skips where there is no card (decided inside the test)."""
import json
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program's kernels build and run only there")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu" and "setup_s" in result["metrics"]
