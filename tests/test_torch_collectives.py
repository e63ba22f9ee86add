"""The port's collectives with a bound ``model`` axis: two CPU processes
over ``torch.distributed`` (gloo), against the single-participant
identity path.  Covers psum / pmax / all_gather / reduce_scatter /
all_to_all and TokenWeave's reduce-scatter + fused add/norm + all-gather
(``kernels/tokenweave.py``) at tp=2, which must equal the unsharded
fused add+RMSNorm of the summed partials."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist import collectives as col
from repro_torch.kernels import rmsnorm as trn

ROOT = Path(__file__).resolve().parents[1]

WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import collectives as col
from repro_torch.kernels import tokenweave

rank, world, port, out = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
col.bind_axis("model", dist.group.WORLD)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
ys = [torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
      for _ in range(world)]
g = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
y = ys[rank]
res = {
    "size": col.axis_size("model"), "index": col.axis_index("model"),
    "psum": col.psum(y, "model"),
    "pmax": col.pmax(y, "model"),
    "all_gather": col.all_gather(y[:, rank * 4:(rank + 1) * 4], "model", dim=1),
    "reduce_scatter": col.reduce_scatter(y, "model", dim=1),
    "all_to_all": col.all_to_all(y, "model", split_dim=1, concat_dim=0),
}
res["s"], res["h"] = tokenweave.fused_ar_add_rmsnorm(y, x, g, axis="model")
torch.save(res, f"{out}/rank{rank}.pt")
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bound_axis_collectives_and_tokenweave(tmp_path):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    ys = [torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
          for _ in range(2)]
    g = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    total = ys[0] + ys[1]
    s_want, h_want = trn.fused_add_rmsnorm_plain(
        x.reshape(-1, 16), total.reshape(-1, 16), g)
    for r, got in enumerate(res):
        assert (got["size"], got["index"]) == (2, r)
        torch.testing.assert_close(got["psum"], total)
        torch.testing.assert_close(got["pmax"], torch.maximum(*ys))
        torch.testing.assert_close(
            got["all_gather"], torch.cat([ys[0][:, 0:4], ys[1][:, 4:8]], 1))
        torch.testing.assert_close(got["reduce_scatter"],
                                   total[:, r * 4:(r + 1) * 4])
        torch.testing.assert_close(
            got["all_to_all"],
            torch.cat([ys[0][:, r * 4:(r + 1) * 4],
                       ys[1][:, r * 4:(r + 1) * 4]], 0))
        torch.testing.assert_close(got["s"], s_want.reshape(2, 8, 16))
        torch.testing.assert_close(got["h"], h_want.reshape(2, 8, 16))


def test_unbound_axis_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert col.axis_size("model") == 1 and col.axis_index("model") == 0
    for fn in (col.psum, col.pmax):
        assert fn(x, "model") is x
    assert col.all_gather(x, "model", dim=1) is x
    assert col.reduce_scatter(x, "model", dim=1) is x
    assert col.all_to_all(x, "model", 0, 1) is x
