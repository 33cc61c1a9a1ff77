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
from haconvdr_torch.ops import _build, fused_attention, fused_topk, topk_stream

PKG = pathlib.Path(haconvdr_torch.__file__).parent
IVF_CLIS = ("build_ivf", "ivf_sweep", "ivf_geometry_check")
CLIS = ("gen_doc_embeddings", "gen_tokenized_doc", "test_retrieval", "test_prj",
        "train_retrieval", "serve", "bm25_search", *IVF_CLIS)
DEVICE_CLIS = ("gen_doc_embeddings", "test_retrieval", "test_prj", "train_retrieval", "serve",
               *IVF_CLIS)
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
    assert {
        "haconvdr_torch.ops.topk_stream", "haconvdr_torch.eval", "haconvdr_torch.eval.metrics",
        "haconvdr_torch.eval.trec", "haconvdr_torch.eval.analysis",
        "haconvdr_torch.data.topiocqa", "haconvdr_torch.data.qrecc", "haconvdr_torch.data.cast",
        "haconvdr_torch.data.prj", "haconvdr_torch.mine", "haconvdr_torch.mine.prj",
        "haconvdr_torch.retrieval", "haconvdr_torch.serve_http", "haconvdr_torch.utils.telemetry",
        "haconvdr_torch.models.hf_import", "haconvdr_torch.mine.analysis", "haconvdr_torch.mine.bm25",
        "haconvdr_torch.preprocess.collections", "haconvdr_torch.preprocess.topiocqa",
        "haconvdr_torch.preprocess.qrecc", "haconvdr_torch.index.ivf",
        "haconvdr_torch.parallel.sharded_ivf", "haconvdr_torch.parallel.mesh",
        "haconvdr_torch.parallel.sharded_search", "haconvdr_torch.parallel.sharded_encode",
        "haconvdr_torch.cli._args", *(f"haconvdr_torch.cli.{c}" for c in CLIS),
    } <= set(mods)
    smoke = _smoke_imports()
    assert "haconvdr_torch.train.trainer" in smoke
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['haconvdr_tpu'] = None\n"
        "sys.modules['transformers'] = None  # imported only inside load_tokenizer\n"
        f"for m in {mods + smoke!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "k.split('.')[0] in ('jax', 'haconvdr_tpu', 'transformers')]\n"
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


def test_entry_points_need_the_card_unless_told_cpu(monkeypatch, tmp_path):
    """Each entry point that takes a device resolves None to CUDA, and
    refuses before it reads anything (the paths below do not exist)."""
    import importlib

    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.models.hf_import import load_model
    from haconvdr_torch.ops.topk import BlockSearcher
    from haconvdr_torch.serve import Retriever

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=0)
    missing = str(tmp_path / "missing")
    refusals = [
        lambda: AnceEncoder.from_jax_params(params, cfg),
        lambda: BlockSearcher(top_k=3),
        lambda: load_model("ANCE_Query", missing),
        lambda: Retriever.load(missing, missing),
        *(lambda c=c: importlib.import_module(f"haconvdr_torch.cli.{c}").main(
            [f"model.pretrained_encoder_path={missing}", f"serve.checkpoint_path={missing}"])
          for c in DEVICE_CLIS),
    ]
    for refuse in refusals:
        with pytest.raises(RuntimeError, match="is_available"):
            refuse()
    assert next(AnceEncoder.from_jax_params(params, cfg, "cpu").parameters()).device.type == "cpu"
    assert BlockSearcher(top_k=3, device="cpu").device.type == "cpu"
    with pytest.raises(FileNotFoundError):  # told cpu, it goes on to read
        load_model("ANCE_Query", missing, device="cpu")
    for c in CLIS:  # the host-only CLIs take no --device
        src = (PKG / "cli" / f"{c}.py").read_text()
        assert ("pop_device" in src) == (c in DEVICE_CLIS), c


@pytest.mark.parametrize("argv, device, rest", [
    (["a=1", "--device", "cpu", "b=2"], "cpu", ["a=1", "b=2"]),
    (["--device=cpu", "--config", "x.toml"], "cpu", ["--config", "x.toml"]),
    (["a=1", "shard_stride=2"], "cuda", ["a=1", "shard_stride=2"]),
    (["a=1", "--device"], None, None),
], ids=["spaced", "equals", "default", "missing_value"])
def test_device_argument(argv, device, rest):
    """The CLIs' one --device parser (cli/_args.py)."""
    from haconvdr_torch.cli._args import pop_device

    if device is None:
        with pytest.raises(ValueError, match="needs a value"):
            pop_device(argv)
    else:
        assert pop_device(argv) == (device, rest)


def test_config_matches_jax_and_states_no_tpu_figure():
    """The port's config.py keeps the JAX package's fields, types and
    defaults (TOML files and overrides read the same), and its comments
    state no TPU figure."""
    import dataclasses

    from haconvdr_torch import config as tconfig
    from haconvdr_tpu import config as jconfig

    names = [n for n, v in vars(jconfig).items()
             if dataclasses.is_dataclass(v) and v.__module__ == jconfig.__name__]
    assert "ServeConfig" in names and "ModelConfig" in names
    for name in names:
        ours, ref = getattr(tconfig, name), getattr(jconfig, name)

        def spec(cls):
            return [(f.name, str(f.type), f.default, f.default_factory)
                    for f in dataclasses.fields(cls)]

        assert [s[:3] for s in spec(ours)] == [s[:3] for s in spec(ref)], name
        assert [dataclasses.asdict(f()) if f is not dataclasses.MISSING else None
                for *_, f in spec(ours)] == [
            dataclasses.asdict(f()) if f is not dataclasses.MISSING else None
            for *_, f in spec(ref)], name
    src = (PKG / "config.py").read_text()
    assert not re.findall(r"QPS|MXU|VMEM|TPU|16 GB", src)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_take_only_the_plain_twins():
    rng = np.random.RandomState(0)
    for mod in (fused_attention, fused_topk, topk_stream):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    qkv = torch.from_numpy(rng.randn(2, 8, 3 * 16).astype(np.float32))
    fused_attention.fused_attention_qkv(qkv, torch.ones(2, 8, dtype=torch.int32), 2)
    q = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
    p = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    fused_topk.fused_topk_block(q, p, 50, 5)
    topk_stream.topk_block_v2(q, p, 50, 5, p_chunk=32)
    assert fused_attention.COUNTS == {"kernel": 0, "plain": 1}
    assert fused_topk.COUNTS == {"kernel": 0, "plain": 1}
    assert topk_stream.COUNTS == {"kernel": 0, "plain": 1}


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


def test_the_multi_device_layer_needs_the_card_unless_told_cpu(monkeypatch, tmp_path):
    """parallel/mesh.py and the modules on it: the default mesh is every
    card and refuses without one; the one-device forms resolve None to
    CUDA and refuse before they read anything; a CPU mesh routes every
    kernel of a search and an encode to its plain twin."""
    from haconvdr_torch import parallel
    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.ops import topk_v4
    from haconvdr_torch.parallel import sharded_ivf
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    assert {"Mesh", "make_mesh", "replicate", "shard_batch", "ShardedIndex", "sharded_topk",
            "encode_batches", "pad_to_multiple", "group_max", "group_sum",
            "encoder_param_pspecs", "shard_params"} <= set(dir(parallel))
    missing = str(tmp_path / "missing")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for refuse in (
            lambda: parallel.make_mesh(),
            lambda: parallel.make_mesh(devices=["cuda"] * 2),
            lambda: sharded_ivf.load_ivf_sharded(missing),
            lambda: sharded_ivf.build_ivf_from_store(parallel.make_mesh(), None),
            lambda: ShardedIndex.from_store(parallel.make_mesh(), None),
        ):
            with pytest.raises(RuntimeError, match="is_available"):
                refuse()
    mesh = parallel.make_mesh(devices=["cpu"] * 4)
    for mod in (fused_attention, fused_topk, topk_v4):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    rng = np.random.RandomState(0)
    idx = ShardedIndex(mesh, rng.randn(500, 8).astype(np.float32), chunk=64)
    idx.search(rng.randn(3, 8).astype(np.float32), 5)
    cfg = ModelConfig.tiny()
    enc = AnceEncoder.from_jax_params(init_params_numpy(cfg, seed=0), cfg, "cpu")
    with torch.inference_mode():
        parallel.sharded_encode.dp_encode_fn(mesh, enc)(
            torch.full((4, 6), 5, dtype=torch.int32), torch.ones(4, 6, dtype=torch.int32))
    assert topk_v4.COUNTS["plain"] > 0 and fused_attention.COUNTS["plain"] > 0
    assert all(v == 0 for k, v in topk_v4.COUNTS.items() if k != "plain")
    assert fused_attention.COUNTS["kernel"] == 0 and fused_topk.COUNTS["kernel"] == 0


def test_wrapper_pieces_take_the_plain_twins_on_cpu():
    """The head-split attention wrapper and the presample on CPU tensors:
    one plain-twin call each, no kernel."""
    rng = np.random.RandomState(1)
    for mod in (fused_attention, fused_topk):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 8, 8).astype(np.float32)) for _ in range(3))
    out = fused_attention.fused_attention(q, k, v, torch.ones(2, 8, dtype=torch.int32))
    assert out.shape == (2, 2, 8, 8)
    p = torch.from_numpy(rng.randn(2048, 8).astype(np.float32))
    fused_topk.fused_topk_block(torch.from_numpy(rng.randn(3, 8).astype(np.float32)), p, 2000,
                                5, presample=16)
    assert fused_attention.COUNTS == {"kernel": 0, "plain": 1}
    assert fused_topk.COUNTS == {"kernel": 0, "plain": 1}


def test_mesh_training_and_the_tp_encode_run_with_jax_blocked():
    """A mesh train step (four CPU slots, dropout on) and a tp-split int8
    encode (dp 2 x tp 2) in a process where ``jax`` and ``haconvdr_tpu``
    cannot be imported: the plain twins only, the split MLP's included."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['haconvdr_tpu'] = None\n"
        "import dataclasses, numpy as np, torch\n"
        "from haconvdr_torch.config import ModelConfig, TrainConfig\n"
        "from haconvdr_torch.models.convert import init_params_numpy\n"
        "from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params\n"
        "from haconvdr_torch.ops import flash_attention as fa, fused_mlp as fm\n"
        "from haconvdr_torch.parallel import make_mesh, shard_params, dp_encode_fn\n"
        "from haconvdr_torch.train.trainer import (build_frozen_encoder, init_train_state,\n"
        "    make_optimizer, make_train_step)\n"
        "cfg = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)\n"
        "tcfg = TrainConfig(accumulation_steps=1, learning_rate=1e-3, is_pseudo_prepos=False,\n"
        "    is_prepos_neg=False, frozen_dtype='int8')\n"
        "mesh = make_mesh(devices=['cpu'] * 4)\n"
        "opt = make_optimizer(tcfg, 4)\n"
        "step = make_train_step(mesh, cfg, tcfg, opt)\n"
        "state = init_train_state(AnceEncoder.from_jax_params(init_params_numpy(cfg, 0), cfg,\n"
        "    'cpu'), opt)\n"
        "frozen = build_frozen_encoder(init_params_numpy(cfg, 1), cfg, tcfg, 'cpu')\n"
        "r = np.random.default_rng(0)\n"
        "b = {k: r.integers(4, 100, (6, 7)).astype(np.int32) for k in ('conv_qp', 'pos_docs',\n"
        "    'neg_docs')}\n"
        "b.update({k + '_mask': np.ones((6, 7), np.int32) for k in list(b)})\n"
        "b['valid'] = np.ones(6, np.int32)\n"
        "_, loss = step(state, frozen, b)\n"
        "assert np.isfinite(float(loss)) and state.global_step == 1\n"
        "assert fa.COUNTS['plain_fwd'] == 3 * cfg.num_hidden_layers and fa.COUNTS['fwd'] == 0\n"
        "c8 = dataclasses.replace(ModelConfig.tiny(), dtype='bfloat16')\n"
        "q = quantize_encoder_params(init_params_numpy(c8, 2))\n"
        "m2 = make_mesh(dp=2, tp=2, devices=['cpu'] * 4)\n"
        "ids = torch.from_numpy(r.integers(4, 100, (4, 9)).astype(np.int32))\n"
        "with torch.inference_mode():\n"
        "    got = dp_encode_fn(m2, shard_params(m2, q, tp=True, cfg=c8))(ids, torch.ones_like(ids))\n"
        "    want = AnceEncoder.from_jax_params(q, c8, 'cpu')(ids, torch.ones_like(ids))\n"
        "assert torch.equal(got, want)\n"
        "assert fm.COUNTS['plain_split_finish'] == 2 * c8.num_hidden_layers\n"
        "assert fm.COUNTS['split_finish'] == 0\n"
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
