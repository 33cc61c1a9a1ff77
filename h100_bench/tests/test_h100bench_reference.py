"""The plain reference: its exact top k against numpy, its query rule and
towers against the port's on the CPU (a test may read both; the
reference itself imports nothing of the port), and what it may import."""

import ast
import json

import numpy as np
import pytest
import torch

from h100_bench.harness import inputs
from h100_bench.harness.cell import BENCH_DIR
from h100_bench.reference.embed import Reference
from h100_bench.reference.query import convqp_ids
from h100_bench.reference.search import Index
from h100_bench.reference.tokenizer import HashWordTokenizer
from h100_bench.tests.tiny import TINY_MODEL

FORBIDDEN = {"jax", "jaxlib", "flax", "haconvdr_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH_DIR).as_posix()
                                        for p in BENCH_DIR.rglob("*.py")))
def test_no_module_imports_jax_and_the_reference_imports_nothing_of_the_port(path):
    names = set(_imports(BENCH_DIR / path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.startswith("reference/"):
        assert "haconvdr_torch" not in names and names <= {"torch", "numpy", "math", "zlib",
                                                          "contextlib", "typing", "__future__",
                                                          "h100_bench"}


@pytest.mark.parametrize("levels", [None, 127, 7])
def test_the_reference_top_k_is_numpy_s_exact_top_k(levels):
    g = torch.Generator().manual_seed(3)
    rows = torch.randn(3000, 32, generator=g)
    q = torch.randn(5, 32, generator=g)
    index = Index(rows, levels)
    s, i = index.topk(q, 50)
    if levels is None:
        want = q.double().numpy() @ rows.double().numpy().T
    else:
        codes, scale = index.rows.double().numpy(), index.scale.double().numpy()
        f = q.double().numpy() * scale
        m = np.abs(f).max(1, keepdims=True)
        qc = np.clip(np.round(f / m * levels), -levels, levels)
        want = (qc @ codes.T) * (m / levels)
    order = np.argsort(-want, axis=1, kind="stable")[:, :50]
    top = np.take_along_axis(want, order, 1)
    assert np.allclose(s.double().numpy(), top, rtol=1e-5, atol=1e-5)
    got = np.take_along_axis(want, i.numpy(), 1)
    assert np.allclose(got, top, rtol=1e-5, atol=1e-5)  # ids of the top scores, ties aside
    assert torch.allclose(index.scores_at(q, i), s, rtol=1e-5, atol=1e-5)
    assert (s[:, :-1] >= s[:, 1:]).all() and (i >= 0).all() and (i < 3000).all()


def test_the_reference_query_rule_builds_the_port_s_ids():
    from haconvdr_torch.config import DataConfig
    from haconvdr_torch.serve import Retriever

    from h100_bench.harness import traffic as gen

    mix = json.loads((BENCH_DIR / "traffic" / "sessions-c128.json").read_text())
    sess = gen.Sessions(mix, 11)
    tok = HashWordTokenizer()
    holder = Retriever.__new__(Retriever)  # only query building: no tower, no index
    holder.tokenizer = tok
    holder.data_cfg = DataConfig(is_train=False, use_PRL=False)
    for j in range(300):
        ex = holder._build_query(*sess.request(j))
        ids, n = convqp_ids(tok, *sess.request(j), max_concat=512)
        assert ex["conv_qp"] == ids and sum(ex["conv_qp_mask"]) == n


@pytest.mark.parametrize("int8", [False, True])
def test_the_reference_towers_follow_the_port_s_on_the_cpu(int8):
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

    from h100_bench.harness.port import port_config

    config = json.loads((BENCH_DIR / "configs" / ("ance-int8.json" if int8 else
                                                    "ance-f32.json")).read_text())
    config.update(TINY_MODEL)
    params = inputs.make_params(config, 5, "cpu")
    port = AnceEncoder.from_jax_params(quantize_encoder_params(params) if int8 else params,
                                       port_config(config), "cpu")
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(5, 1000, (6, 64), generator=g)
    lengths = torch.tensor([64, 40, 9, 3, 33, 17])
    mask = (torch.arange(64)[None, :] < lengths[:, None]).to(torch.int64)
    ids = ids * mask
    with torch.inference_mode():
        want = port(ids, mask)
    got = Reference(config, params, "cpu").embed(ids, mask)
    err = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    assert err < 1e-5, err


def test_the_int4_control_is_far_from_the_int8_reference():
    config = json.loads((BENCH_DIR / "configs" / "ance-int8.json").read_text())
    config.update(TINY_MODEL)
    params = inputs.make_params(config, 6, "cpu")
    ids = torch.randint(5, 1000, (4, 64), generator=torch.Generator().manual_seed(2))
    mask = torch.ones_like(ids)
    ref = Reference(config, params, "cpu").embed(ids, mask)
    ctrl = Reference(config, params, "cpu", control=True).embed(ids, mask)
    # the int4 control sits a few percent off at two layers of 128, the port's
    # int8 tower on the CPU (its plain twins) within 1e-5 of the reference
    assert ((ctrl - ref).norm(dim=1) / ref.norm(dim=1)).min().item() > 0.01
