"""The PyTorch port (haconvdr_torch): imports without JAX, refuses a CUDA
device it does not have, and routes CPU tensors only to the plain twins."""

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


def _modules():
    root = PKG.parent
    return sorted(
        ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "haconvdr_torch.serve" in mods and "haconvdr_torch.ops.fused_topk" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=PKG.parent,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    offenders = [p.name for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device(None).type == "cpu"
    assert resolve_device("cpu").type == "cpu"


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
    t = to_torch(a.astype(ml_dtypes.bfloat16))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t), to_numpy(torch.from_numpy(a).bfloat16()))
