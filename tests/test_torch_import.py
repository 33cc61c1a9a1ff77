"""The PyTorch port (haconvdr_torch): imports without JAX and without the
JAX package, runs on the card unless told otherwise and refuses a CUDA
device it does not have, and routes CPU tensors only to the plain twins."""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import haconvdr_torch
from haconvdr_torch.device import resolve_device, to_numpy, to_torch
from haconvdr_torch.ops import _build, fused_attention, fused_topk

PKG = pathlib.Path(haconvdr_torch.__file__).parent
SMOKE = PKG.parent / "chip_smoke.py"


def _modules():
    root = PKG.parent
    return sorted(
        ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _smoke_imports():
    """Every module chip_smoke.py imports, at top level or in a function."""
    mods = set()
    for node in ast.walk(ast.parse(SMOKE.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module)
    return sorted(mods)


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "haconvdr_torch.serve" in mods and "haconvdr_torch.train.trainer" in mods
    smoke = _smoke_imports()
    assert "haconvdr_torch.train.trainer" in smoke
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['haconvdr_tpu'] = None\n"
        f"for m in {mods + smoke!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "k.split('.')[0] in ('jax', 'haconvdr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=PKG.parent,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|haconvdr_tpu)\b", re.M)
    files = [*PKG.rglob("*.py"), SMOKE]
    offenders = [p.name for p in files if pat.search(p.read_text())]
    assert offenders == []


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_need_the_card_unless_told_cpu(monkeypatch):
    """Each entry point that takes a device resolves None to CUDA."""
    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.ops.topk import BlockSearcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        AnceEncoder.from_jax_params(params, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        BlockSearcher(top_k=3)
    assert next(AnceEncoder.from_jax_params(params, cfg, "cpu").parameters()).device.type == "cpu"
    assert BlockSearcher(top_k=3, device="cpu").device.type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_take_only_the_plain_twins():
    rng = np.random.RandomState(0)
    for mod in (fused_attention, fused_topk):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    qkv = torch.from_numpy(rng.randn(2, 8, 3 * 16).astype(np.float32))
    fused_attention.fused_attention_qkv(qkv, torch.ones(2, 8, dtype=torch.int32), 2)
    q = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
    p = torch.from_numpy(rng.randn(50, 8).astype(np.float32))
    fused_topk.fused_topk_block(q, p, 50, 5)
    assert fused_attention.COUNTS == {"kernel": 0, "plain": 1}
    assert fused_topk.COUNTS == {"kernel": 0, "plain": 1}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()


def test_numpy_roundtrip_bfloat16():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    t = to_torch(a.astype(ml_dtypes.bfloat16), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t), to_numpy(torch.from_numpy(a).bfloat16()))
