"""The control of each served cell on the card, at the cell's own size:
the reference with its matmuls in fp8, a step below the bfloat16 the
configuration serves in, put in the program's place, comes out not
correct where the program on the same seed comes out correct.  A short
window at the cell's load; the card decides inside the fixture, so the
test skips without one."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SERVED = ("chatglm3-6b.chat-sat", "chatglm3-6b.chat-rate",
          "chatglm3-6b.decode-long")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run only on the card")


def _run(script: str, cell: str) -> dict:
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", script),
         "--workload", cell, "--seed", "3900000001", "--seconds", "10",
         "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVED)
def test_the_control_fails_the_limit_the_program_keeps(card, cell):
    prog, ctrl = _run("run.py", cell), _run("control.py", cell)
    assert prog["correct"], prog["checks"]
    assert not ctrl["correct"], ctrl["checks"]
    gap = ctrl["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"], ctrl["checks"]
