"""The DeepSeek-V2 query tower (models/deepseek_v2.py), its expert layer
(ops/moe.py's plain twin; the CUDA kernels are held to it on the card in
tests/test_torch_cuda.py) and the serving path it runs on, on the CPU at a
tiny DeepSeek-V2 shape: hidden 64, one dense and two expert layers of 8
experts (top 2, one shared), latent rank 16, nope 8, rope 4, v 8, YaRN
factor 4.

Tolerances: a float32 tower against the float32 reference within 1e-4 of
the embedding's norm (the same equations, summed in another order); packed
against each row alone within 1e-5; a bfloat16 tower within 5% (bf16 weights
and activations through three layers of random weights, measured ~1-2%).
"""

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from haconvdr_torch.config import DataConfig, DeepseekV2Config, ModelConfig, SearchConfig
from haconvdr_torch.models import build_tower, hf_import
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.models.deepseek_v2 import DeepseekV2Encoder, rope_inv_freq, softmax_scale
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.ops import moe, pack
from h100_bench.reference.deepseek_v2 import Reference, inv_freq
from haconvdr_torch.serve import BatchingRetriever, Retriever
from haconvdr_torch.utils.telemetry import read_counters
from haconvdr_torch.utils.testing import HashTokenizer

ROOT = Path(__file__).resolve().parents[1]


def _cfg(dtype="float32", **kw):
    return DeepseekV2Config.tiny(dtype=dtype, **kw)


def _params(cfg, seed=3, std=0.2):
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in DeepseekV2Encoder(cfg).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    return {n: (1.0 + 0.1 * torch.randn(s, generator=g)) if n.endswith("norm.weight")
            else torch.randn(s, generator=g) * std for n, s in shapes.items()}


def _batch(cfg, lens, L=None, seed=0):
    rng = np.random.default_rng(seed)
    L = L or max(lens)
    mask = (np.arange(L)[None, :] < np.asarray(lens)[:, None]).astype(np.int64)
    ids = rng.integers(5, cfg.vocab_size, (len(lens), L)) * mask
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _reference(cfg, params, ids, mask):
    rows = [ids[b, : int(mask[b].sum())].tolist() for b in range(ids.shape[0])]
    return Reference(dataclasses.asdict(cfg), params, "cpu").embed(rows)


def _rel(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


LENS = [20, 7, 1, 13, 16, 3]


def test_float32_tower_is_the_reference():
    cfg = _cfg()
    params = _params(cfg)
    enc = DeepseekV2Encoder.from_params(params, cfg, "cpu")
    ids, mask = _batch(cfg, LENS)
    with torch.inference_mode():
        out = enc(ids, mask, host_mask=mask.numpy())
    assert out.shape == (len(LENS), cfg.hidden_size) and out.dtype == torch.float32
    assert _rel(out, _reference(cfg, params, ids, mask)) <= 1e-4


def test_bfloat16_tower_is_near_the_reference():
    cfg = _cfg("bfloat16")
    params = _params(cfg)
    enc = DeepseekV2Encoder.from_params(params, cfg, "cpu")
    assert enc.embed_tokens.weight.dtype == torch.bfloat16
    ids, mask = _batch(cfg, LENS)
    with torch.inference_mode():
        out = enc(ids, mask, host_mask=mask.numpy())
    assert _rel(out, _reference(_cfg(), params, ids, mask)) <= 0.05


@pytest.mark.parametrize("extra", [0, 5, 40])
def test_packed_batch_equals_each_row_alone_at_any_padding(extra):
    """The packed forward of a padded batch (any extra padding) gives each
    row what that row gives alone, unpadded: the plan drops the padding and
    the causal attention never reads it."""
    cfg = _cfg()
    enc = DeepseekV2Encoder.from_params(_params(cfg), cfg, "cpu")
    ids, mask = _batch(cfg, LENS, L=max(LENS) + extra)
    before = dict(pack.COUNTS)
    with torch.inference_mode():
        packed = enc(ids, mask, host_mask=mask.numpy())
        alone = torch.cat([enc(ids[b:b + 1, :n], mask[b:b + 1, :n], host_mask=mask[b:b + 1, :n].numpy())
                           for b, n in enumerate(LENS)])
    assert _rel(packed, alone) <= 1e-5
    assert pack.COUNTS["rows"] - before["rows"] == 2 * sum(LENS)
    assert pack.COUNTS["plan_reads"] == before["plan_reads"]


def test_the_plan_is_read_back_only_without_a_host_mask():
    cfg = _cfg()
    enc = DeepseekV2Encoder.from_params(_params(cfg), cfg, "cpu")
    ids, mask = _batch(cfg, LENS)
    reads = pack.COUNTS["plan_reads"]
    with torch.inference_mode():
        a = enc(ids, mask)
        b = enc(ids, mask, host_mask=mask.numpy())
    assert pack.COUNTS["plan_reads"] == reads + 1 and torch.equal(a, b)


def test_an_empty_row_stays_finite_and_leaves_the_others_alone():
    cfg = _cfg()
    enc = DeepseekV2Encoder.from_params(_params(cfg), cfg, "cpu")
    ids, mask = _batch(cfg, [9, 4])
    mask2 = mask.clone()
    mask2[1] = 0
    with torch.inference_mode():
        out = enc(ids, mask2, host_mask=mask2.numpy())
        first = enc(ids[:1], mask[:1], host_mask=mask[:1].numpy())
    assert bool(torch.isfinite(out).all()) and _rel(out[:1], first) <= 1e-5


def test_yarn_frequencies_and_scale_are_the_published_ones():
    cfg = DeepseekV2Config()
    assert torch.equal(rope_inv_freq(cfg), inv_freq(dataclasses.asdict(cfg)))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    inv = rope_inv_freq(cfg)
    # beta_fast 32 / beta_slow 1 over the original 4,096 positions: the
    # fastest dims keep RoPE's frequencies, the slowest are divided by 40
    base = 1.0 / (10000 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    assert torch.equal(inv[:10], base[:10])
    assert torch.allclose(inv[-8:], base[-8:] / 40)


# -- the expert layer's plain twin ------------------------------------------


def _dense_experts(x, gate, w13, w2, k, scale):
    """Every expert on every token, masked by the route: the twin's sum
    written another way."""
    p = torch.softmax(x.double() @ gate.double().T, dim=-1)
    w, e = torch.topk(p, k, dim=-1)
    I = w13.shape[1] // 2
    out = torch.zeros(x.shape, dtype=torch.float64)
    for j in range(gate.shape[0]):
        h = F.silu(x.double() @ w13[j, :I].double().T) * (x.double() @ w13[j, I:].double().T)
        y = h @ w2[j].double().T
        sel = (e == j).double() * w * scale
        out += sel.sum(1, keepdim=True) * y
    return out


def _moe_case(case):
    g = torch.Generator().manual_seed(11)
    T, H, I, E, k = {"T1": (1, 16, 8, 8, 2), "empty_expert": (40, 16, 8, 8, 2),
                     "one_expert": (33, 16, 8, 8, 1), "many": (100, 24, 16, 6, 3)}[case]
    x = torch.randn(T, H, generator=g)
    gate = torch.randn(E, H, generator=g)
    if case == "empty_expert":
        gate[3] = -gate.abs().sum(0)
        x = x.abs()
    if case == "one_expert":
        gate.zero_()
        gate[5] = 1
        x = x.abs() + 0.1
    w13 = torch.randn(E, 2 * I, H, generator=g) * H ** -0.5
    w2 = torch.randn(E, H, I, generator=g) * I ** -0.5
    return x, gate, w13, w2, k


@pytest.mark.parametrize("case", ["T1", "empty_expert", "one_expert", "many"])
def test_routed_experts_plain_twin_at_the_edges(case):
    x, gate, w13, w2, k = _moe_case(case)
    before = dict(moe.COUNTS)
    out = moe.routed_experts(x, gate, w13, w2, k, 1.5)
    ref = _dense_experts(x, gate, w13, w2, k, 1.5)
    assert out.dtype == x.dtype and torch.allclose(out.double(), ref, rtol=1e-5, atol=1e-5)
    assert moe.COUNTS["plain"] == before["plain"] + 1 and moe.COUNTS["kernel"] == before["kernel"]
    assert moe.COUNTS["tokens"] == before["tokens"] + x.shape[0]
    assert moe.COUNTS["assignments"] == before["assignments"] + x.shape[0] * k
    _, e = moe.route_plain(x, gate, k)
    if case == "empty_expert":
        assert not bool((e == 3).any())
    if case == "one_expert":
        assert bool((e == 5).all())


def test_the_load_accumulators_count_each_expert_and_the_largest_load():
    x, gate, w13, w2, k = _moe_case("one_expert")  # every token on expert 5
    loads0 = {tuple(t.shape): t.clone() for t in moe.expert_loads()}
    max0 = read_counters()["ops.moe"]["max_load_sum"]
    moe.routed_experts(x, gate, w13, w2, k)
    loads = [t for t in moe.expert_loads() if t.shape == (8,)][0]
    before = loads0.get((8,), torch.zeros(8, dtype=torch.int64))
    assert (loads - before).tolist() == [0, 0, 0, 0, 0, x.shape[0], 0, 0]
    assert read_counters()["ops.moe"]["max_load_sum"] == max0 + x.shape[0]


def test_routed_experts_refuses_shapes_that_do_not_agree():
    x, gate, w13, w2, k = _moe_case("many")
    with pytest.raises(ValueError, match="do not agree"):
        moe.routed_experts(x, gate, w13[:, :-1], w2, k)
    with pytest.raises(ValueError, match="top_k"):
        moe.routed_experts(x, gate, w13, w2, 7)


# -- the serving path -------------------------------------------------------

QUESTIONS = [("what is the capital", [("where is france", "europe")]),
             ("how tall is it", [("what is the eiffel tower", "a tower in paris"),
                                 ("who built it", "gustave eiffel")]),
             ("when", []), ("and the river", [("what flows", "the seine")])]


def _retriever(dtype="float32", rows=300):
    cfg = _cfg(dtype, vocab_size=200)
    params = _params(cfg, std=0.3)
    g = torch.Generator().manual_seed(5)
    index = torch.randn(rows, cfg.hidden_size, generator=g)
    r = Retriever(HashTokenizer(cfg.vocab_size), params, cfg, index,
                  offset2pid=np.arange(rows) * 3 + 1,
                  data_cfg=DataConfig(is_train=False, use_PRL=False, max_concat_length=48),
                  search_cfg=SearchConfig(top_k=10, per_device_test_batch_size=4), device="cpu")
    return cfg, params, index, r


def _reference_top(cfg, params, index, retriever, k=10):
    rows = []
    for q, h in QUESTIONS:
        ex = retriever.build_query(q, h)
        n = int(np.sum(ex["conv_qp_mask"]))
        rows.append(list(ex["conv_qp"][:n]))
    emb = Reference(dataclasses.asdict(_cfg(vocab_size=200)), params, "cpu").embed(rows)
    s, i = torch.topk(emb @ index.T, k, dim=1)
    return s.numpy(), i.numpy() * 3 + 1


def test_retriever_builds_the_decoder_tower_and_answers_as_the_reference():
    cfg, params, index, r = _retriever()
    assert type(r.encoder) is DeepseekV2Encoder
    ref_s, ref_ids = _reference_top(cfg, params, index, r)
    for (q, h), rs, ri in zip(QUESTIONS, ref_s, ref_ids):
        got = r.retrieve(q, h)
        assert [p for p, _ in got] == ri.tolist()
        np.testing.assert_allclose([s for _, s in got], rs, rtol=1e-4, atol=1e-4)


def test_batching_retriever_over_the_decoder_answers_as_the_reference():
    cfg, params, index, r = _retriever()
    ref_s, ref_ids = _reference_top(cfg, params, index, r)
    with BatchingRetriever(r, max_batch=4, max_wait_ms=200.0) as b:
        futs = [b.submit(q, h) for q, h in QUESTIONS]
        got = [f.result(timeout=120) for f in futs]
    assert b.stats()["dispatches"] < len(QUESTIONS)
    for ans, rs, ri in zip(got, ref_s, ref_ids):
        assert [p for p, _ in ans] == ri.tolist()
        np.testing.assert_allclose([s for _, s in ans], rs, rtol=1e-4, atol=1e-4)


def test_retriever_takes_tensors_on_the_device_as_they_are():
    cfg = _cfg("bfloat16", vocab_size=200)
    params = {n: t.to(torch.bfloat16) for n, t in _params(cfg).items()}
    r = Retriever(HashTokenizer(200), params, cfg, torch.randn(50, cfg.hidden_size),
                  device="cpu")
    assert r.encoder.embed_tokens.weight.data_ptr() == params["embed_tokens.weight"].data_ptr()
    with pytest.raises(ValueError, match="int8"):
        Retriever(HashTokenizer(200), params, cfg, torch.randn(50, cfg.hidden_size),
                  device="cpu", encoder_int8=True)


def test_build_tower_picks_the_class_by_config_and_refuses_an_int8_decoder():
    """``models.build_tower``: the DeepSeek-V2 tower for a DeepseekV2Config,
    which has no int8 route, and the ANCE tower, int8 on request,
    otherwise."""
    cfg = _cfg(vocab_size=200)
    params = _params(cfg)
    assert type(build_tower(params, cfg, "cpu")) is DeepseekV2Encoder
    with pytest.raises(ValueError, match="no int8 route"):
        build_tower(params, cfg, "cpu", int8=True)
    ance = ModelConfig.tiny()
    for int8 in (False, True):
        tower = build_tower(init_params_numpy(ance, seed=1), ance, "cpu", int8=int8)
        assert type(tower) is AnceEncoder and tower.int8 == int8


def test_model_config_keeps_the_ance_defaults():
    assert DeepseekV2Config().model_type == "DEEPSEEK_V2"
    base = {f.name for f in dataclasses.fields(ModelConfig)}
    assert dataclasses.asdict(ModelConfig()) == {
        k: v for k, v in dataclasses.asdict(ModelConfig()).items() if k in base}
    assert ModelConfig().model_type == "ANCE" and not hasattr(ModelConfig(), "n_routed_experts")


# DeepSeek-V2-Lite's config.json (the catalog row's keys)
LITE = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
        "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
        "max_position_embeddings": 163840, "model_type": "deepseek_v2",
        "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
        "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
        "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
        "num_key_value_heads": 16, "q_lora_rank": None, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                         "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                         "type": "yarn"},
        "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
        "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
        "v_head_dim": 128, "vocab_size": 102400}


def test_config_from_hf_reads_a_deepseek_v2_config(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(LITE))
    cfg = hf_import.config_from_hf(str(tmp_path))
    assert isinstance(cfg, DeepseekV2Config) and cfg.model_type == "DEEPSEEK_V2"
    for key in hf_import._DEEPSEEK_V2_KEYS:
        assert getattr(cfg, key) == LITE[key], key
    assert cfg.embedding_dim == 2048 and cfg.pretrained_encoder_path == str(tmp_path)
    assert dataclasses.replace(cfg, pretrained_encoder_path="") == DeepseekV2Config()
    for bad in ({"n_group": 8, "topk_group": 3}, {"hidden_act": "gelu"},
                {"model_type": "llama"}):
        with pytest.raises(ValueError):
            hf_import.deepseek_v2_config({**LITE, **bad})


def test_the_benchmark_reference_is_the_repository_s_and_imports_no_kernel():
    ours = (ROOT / "h100_bench" / "reference" / "deepseek_v2.py").read_text()
    assert not (ROOT / "haconvdr_torch" / "reference").exists()  # one reference, not two
    assert "haconvdr_torch" not in ours.replace("haconvdr_torch/", "") and "jax" not in ours
    assert "allow_tf32 = False" in ours


# -- the benchmark's work count and its tiny cell ---------------------------


def _bench():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from h100_bench.harness import work_moe

    return work_moe, json.loads((ROOT / "h100_bench" / "configs"
                                 / "deepseek-v2-lite-bf16.json").read_text())


def test_work_counts_the_published_active_parameters():
    W, m = _bench()
    assert W.active_params(m) == 2_241_593_344  # ~2.24B a token
    assert W.expert_layers(m) == 26
    attn = 2 * 16 * (192 + 128) * 27
    w = W.tower_work([10, 1], m)
    assert w.ops["bfloat16"] == pytest.approx(2 * 2_241_593_344 * 11 + attn * (55 + 1))
    assert w.nbytes == 2 * W.weight_count(m)
    e = W.expert_work(1000, m)
    assert e.ops["bfloat16"] == 2 * 1000 * 6 * 3 * 2048 * 1408 * 26
    assert e.nbytes == 2 * 64 * 3 * 2048 * 1408 * 26
    for key, value in LITE.items():  # the configuration keeps the published config
        assert m[key] == value, key


TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=96,
            vocab_size=1000, max_position_embeddings=256, embedding_dim=64,
            moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
            v_head_dim=8, max_concat_length=64,
            # at width 64 the full tower's scales leave every fault inside the
            # rounding; at these each fault reads >= 0.1
            init_std=0.08, expert_init_std=0.08, router_init_std=0.3, shared_init_std=0.04)


def _tiny_cell():
    _bench()
    from h100_bench.harness.cell import load_cell

    cell = load_cell("dsv2lite-sessions-c128")
    c = json.loads(json.dumps(cell.config))
    c.update(TINY)
    c["rope_scaling"] = dict(c["rope_scaling"], factor=4.0, original_max_position_embeddings=16)
    c["index"].update(rows=5000, dim=64, top_k=10)
    # a float32 tower: in bf16, top 2 of 8 experts flip where the float32
    # router's margin is below bf16's resolution, and one flip at a
    # request's last token moves its embedding ~12% (requests 86 and 97 of
    # this seed; test_tiny_bf16_misses_are_routing_flips_not_the_port)
    c["tower"] = dict(c["tower"], dtype="float32")
    c["check"] = {"sample": 100_000}  # every answer of the tiny window is held
    t = json.loads(json.dumps(cell.traffic))
    t.update(max_batch=4, clients=8)
    t["sessions"].update(words=300, pool=64, question_words=[2, 5], answer_words=[1, 4],
                         passage_words=[3, 10], turns=[1, 4])
    cell.config, cell.traffic = c, t
    return cell


@pytest.mark.parametrize("fault", [None, "top5", "no_shared", "stale", "altered_search"])
def test_the_cell_at_a_tiny_size_is_correct_and_each_fault_is_not(fault):
    cell = _tiny_cell()
    from h100_bench import faults_moe
    from h100_bench.harness.runner import execute

    import contextlib

    ctx = faults_moe.planted(fault, cell.driver) if fault else contextlib.nullcontext()
    with ctx:
        line, correct = execute(cell, 2**33 + 5, 0.5, False, torch.device("cpu"),
                                time.perf_counter())
    assert line["attempted"] > 0 and correct == (fault is None), line["checks"]



def test_tiny_bf16_misses_are_routing_flips_not_the_port():
    """The tiny cell's requests 86 and 97 (seed 2**33 + 5): the float32 port
    lies within 1e-5 of the reference, the bf16 port ~12-15% off, and the
    bf16 tower routes a token otherwise than the float32 one only where the
    float32 router's k-th and (k+1)-th probabilities lie within 2^-8."""
    cell = _tiny_cell()
    config = cell.config
    from h100_bench.harness import inputs_moe
    from h100_bench.harness import traffic as gen
    from h100_bench.reference.query import convqp_ids
    from h100_bench.reference.tokenizer import HashWordTokenizer

    seed, k = 2**33 + 5, config["num_experts_per_tok"]
    sess = gen.Sessions(cell.traffic, seed)
    tok = HashWordTokenizer(config["vocab_size"])
    params = inputs_moe.make_params(config, seed, torch.device("cpu"))
    ref = Reference(config, params, torch.device("cpu"))
    cfg = hf_import.deepseek_v2_config(config)
    routes = {}
    orig = moe.routed_experts

    def spy(x, gate, w13, w2, top_k, scale=1.0, plain=False):
        p = torch.softmax(F.linear(x.float(), gate.float()), -1)
        top = torch.topk(p, top_k + 1, -1)
        routes.setdefault(x.dtype, []).append(
            (top.indices[:, :top_k].sort(-1).values, top.values[:, top_k - 1] - top.values[:, top_k]))
        return orig(x, gate, w13, w2, top_k, scale, plain)

    for j in (86, 97):
        row, n = convqp_ids(tok, *sess.request(j), max_concat=config["max_concat_length"])
        want = ref.embed([row[:n]])
        ids = torch.tensor([row])
        mask = torch.zeros_like(ids)
        mask[0, :n] = 1
        err = {}
        routes.clear()
        moe.routed_experts = spy
        try:
            for dt in ("bfloat16", "float32"):
                enc = DeepseekV2Encoder.from_params(params, dataclasses.replace(cfg, dtype=dt),
                                                    "cpu")
                with torch.inference_mode():
                    got = enc(ids, mask, host_mask=mask.numpy())
                err[dt] = float((got - want).norm() / want.norm())
        finally:
            moe.routed_experts = orig
        assert err["float32"] <= 1e-5 and err["bfloat16"] >= 0.05, err
        flips = 0
        for (eb, _), (ef, margin) in zip(routes[torch.bfloat16], routes[torch.float32]):
            moved = (eb != ef).any(-1)
            flips += int(moved.sum())
            assert bool((margin[moved] < 2.0 ** -8).all()), margin[moved]
        assert flips >= 1 and k == 2
