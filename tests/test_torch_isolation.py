"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py`` and no ``examples/torch_*.py`` imports JAX or the JAX
package, the port imports in a
process where ``jax`` cannot be imported, and its entry points refuse to
fall back to the CPU on a machine without a GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _port_files():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_triton_imports(path):
    """Every kernel of the port is CUDA C++ built by ``kernels/_build.py``:
    nothing imports Triton."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] != "triton" for n in names), \
            f"{path.relative_to(ROOT)}:{node.lineno} imports triton"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import pkgutil, importlib, repro_torch, repro_torch.api\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.api import compile\n"
        "p = compile('chatglm3-6b', smoke=True, device='cpu')\n"
        "assert p.init_params(0)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_importing_the_port_makes_cublas_sum_in_f32():
    """PyTorch's default lets cuBLAS reduce a 16-bit product's split-K
    partial sums in 16 bits; the port's products, like the JAX package's,
    sum in f32 to the end (``repro_torch/__init__.py``)."""
    code = ("import torch\n"
            "m = torch.backends.cuda.matmul\n"
            "assert m.allow_bf16_reduced_precision_reduction\n"
            "import repro_torch\n"
            "assert not m.allow_bf16_reduced_precision_reduction\n"
            "assert not m.allow_fp16_reduced_precision_reduction\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_gpu():
    from repro_torch.api import compile, resolve_device
    prog = compile("smollm-135m", smoke=True)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prog.init_params(0)
    params = prog.init_params(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prog.serve(params)
    assert prog.serve(params, device="cpu").device.type == "cpu"


def _smoke_model():
    from repro_torch.api import compile
    prog = compile("smollm-135m", smoke=True, device="cpu")
    return prog.model, prog.init_params(0)


def _serve_engine(device=None):
    from repro_torch.serve import ServeConfig, ServeEngine
    model, params = _smoke_model()
    return ServeEngine(model, params, "sequential",
                       ServeConfig(max_batch=2, s_max=64,
                                   prefill_buckets=(16, 64)), device=device)


def _kv_cache(device=None):
    from repro_torch.serve import KVCacheManager
    return KVCacheManager(_smoke_model()[0], 2, 64, device=device)


def _init_params(device=None):
    return _smoke_model()[0].init_params(0, device=device)


def _module_init(device=None):
    segs, _ = _smoke_model()[0].build_segments("prefill", 2, 16, s_max=16)
    return segs[0].module.init(0, device=device)


def _params_from_numpy(device=None):
    import numpy as np

    from repro_torch.convert import params_from_numpy
    return params_from_numpy({"w": np.ones((2, 3), np.float32)},
                             device=device)


@pytest.mark.parametrize("make", [_serve_engine, _kv_cache, _init_params,
                                  _module_init, _params_from_numpy],
                         ids=["ServeEngine", "KVCacheManager",
                              "LM.init_params", "Module.init",
                              "params_from_numpy"])
def test_constructors_default_to_the_gpu(make):
    """Each constructor that places tensors runs on the card unless asked
    for the CPU: without a card it raises, naming the way out."""
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") is not None


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without a GPU (here) it exits non-zero and prints no result; alone
    in a directory it does the same wherever it runs."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [lone]
    if not torch.cuda.is_available():
        runs.append(ROOT / "chip_smoke.py")
    for script in runs:
        res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
