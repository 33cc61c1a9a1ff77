"""The packed inference forward of the port's tower (haconvdr_torch/ops/pack.py,
models/encoder.encode_split) against the padded forward it replaces.

An inference forward runs the token-wise layers on each row's kept span
only and attention on the batch trimmed to its longest row; the padded
forward (``encoder._encode`` without a plan, the layout train mode keeps)
runs every position.  Tolerances: float32 towers within 1e-6 of the
largest |element| (the denses round over another row count); int8 towers
(bf16 carry, the fused route through the plain twins) bit for bit (every
code is per token and every int32 sum exact).
"""

import numpy as np
import pytest
import torch

from haconvdr_torch.cli.ivf_geometry_check import embed_corpus
from haconvdr_torch.config import ModelConfig, TrainConfig
from haconvdr_torch.data.loader import batch_iter
from haconvdr_torch.index.build import encode_corpus
from haconvdr_torch.index.store import TokenizedCorpus, TokenizedCorpusWriter
from haconvdr_torch.models import encoder as E
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.ops import fused_ln, fused_mlp, pack
from haconvdr_torch.parallel.mesh import make_mesh
from haconvdr_torch.parallel.sharded_encode import PIPELINE_DEPTH, encode_batches, shard_params
from haconvdr_torch.train import trainer as T


def _cfg(dtype="float32"):
    return ModelConfig.tiny(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                            max_position_embeddings=80, dtype=dtype)


def _params(cfg, int8):
    p = init_params_numpy(cfg, seed=3)
    return E.quantize_encoder_params(p) if int8 else p


def _batch(cfg, B=9, L=64, seed=0):
    """Mixed lengths: a full-width row, a length-1 row, a row whose mask is
    not a prefix (holes, and a masked first position)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, cfg.vocab_size, size=(B, L)).astype(np.int32)
    lens = rng.randint(2, L, size=B)
    lens[0], lens[1] = L, 1
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    mask[2] = 0
    mask[2, [1, 2, 5, 9, 10]] = 1
    return ids * mask, mask


def _zero_pack_counts():
    for k in pack.COUNTS:
        pack.COUNTS[k] = 0


def _towers(case, cfg, params):
    if case == "tp2":
        return shard_params(make_mesh(dp=1, tp=2, devices=["cpu"] * 2), params, tp=True, cfg=cfg)
    return [E.AnceEncoder.from_jax_params(params, cfg, "cpu")]


@pytest.mark.parametrize("case,dtype,int8,use_mean", [
    ("f32", "float32", False, False),
    ("int8_fused", "bfloat16", True, False),
    ("use_mean", "float32", False, True),
    ("int8_use_mean", "bfloat16", True, True),
    ("tp2", "bfloat16", True, False),
    ("tp2_f32", "float32", False, False),
])
@pytest.mark.parametrize("L", [64, 77])
def test_packed_forward_equals_padded(case, dtype, int8, use_mean, L):
    cfg = _cfg(dtype)
    towers = _towers(case.split("_")[0], cfg, _params(cfg, int8))
    ids, mask = _batch(cfg, L=L)
    x, m = torch.from_numpy(ids), torch.from_numpy(mask)
    before = dict(fused_ln.COUNTS), dict(fused_mlp.COUNTS)
    with torch.inference_mode():
        packed = E.encode_split(towers, x, m, use_mean=use_mean, host_mask=mask).numpy()
        padded = E._encode(towers, x, m, use_mean=use_mean).numpy()
    assert packed.shape == (ids.shape[0], cfg.embedding_dim)
    if int8:  # the fused route ran: LayerNorm with codes and the MLP block
        assert fused_ln.COUNTS["plain"] > before[0]["plain"]
        key = "plain_split_up" if case.startswith("tp2") else "plain"
        assert fused_mlp.COUNTS[key] > before[1][key]
        np.testing.assert_array_equal(packed, padded)
    else:
        assert np.abs(packed - padded).max() <= 1e-6 * np.abs(padded).max()


def test_packed_forward_of_a_row_without_a_valid_token_is_finite():
    """A row with no mask-one position keeps position 0 (what CLS reads);
    the other rows are as in the padded forward."""
    cfg = _cfg()
    enc = E.AnceEncoder.from_jax_params(_params(cfg, False), cfg, "cpu")
    ids, mask = _batch(cfg)
    mask[3] = 0
    x, m = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        packed = enc(x, m, host_mask=mask).numpy()
        padded = E._encode([enc], x, m).numpy()
    assert np.isfinite(packed).all()
    rest = np.arange(len(ids)) != 3
    assert np.abs(packed[rest] - padded[rest]).max() <= 1e-6 * np.abs(padded).max()


@pytest.mark.parametrize("mask,lengths,width,index", [
    # prefixes: spans one after the other, width rounded up to ALIGN
    ([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], [3, 1], 5, [0, 1, 2, 5, 0, 3]),
    # holes stay in the span; a row without a one keeps position 0
    ([[1, 0, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0]], [3, 1, 2], 6,
     [0, 1, 2, 6, 12, 13, 0, 3, 4]),
    # a full-width row: nothing trimmed
    ([[1] * 20, [1] * 3 + [0] * 17], [20, 3], 20, list(range(20)) + [20, 21, 22, 0, 20]),
    # the width is the longest span rounded up to ALIGN, below the batch's
    ([[1] * 17 + [0] * 23, [1] * 2 + [0] * 38], [17, 2], 32,
     list(range(17)) + [32, 33, 0, 17]),
])
def test_plan_on_hand_made_masks(mask, lengths, width, index):
    _zero_pack_counts()
    p = pack.Plan(np.asarray(mask, np.int32))
    np.testing.assert_array_equal(p.lengths, lengths)
    assert p.width == width and p.rows == sum(lengths)
    np.testing.assert_array_equal(p.index, index)
    kept, starts = p.to(torch.device("cpu"))
    np.testing.assert_array_equal(kept.numpy(), index[: p.rows])
    np.testing.assert_array_equal(starts.numpy(), index[p.rows :])
    mask = np.asarray(mask)
    assert pack.COUNTS == {"forwards": 1, "slots": mask.size, "rows": sum(lengths),
                           "valid": int((mask != 0).sum()), "plan_reads": 0}


def test_plan_refuses_a_host_mask_of_another_shape():
    m = torch.ones(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        pack.plan_of(m, np.ones((2, 7), np.int32))


def test_scatter_and_gather_are_inverse_on_the_kept_positions():
    p = pack.Plan(np.array([[1, 1, 0, 0], [1, 1, 1, 0], [1, 0, 0, 0]]))
    kept, _ = p.to(torch.device("cpu"))
    x = torch.arange(p.rows * 2, dtype=torch.float32).reshape(p.rows, 2) + 1
    buf = pack.scatter(torch.zeros(3 * p.width, 2), kept, x)
    assert torch.equal(pack.gather(buf.view(3, p.width, 2), kept), x)
    assert int((buf != 0).any(dim=1).sum()) == p.rows  # the rest stays zero


def test_train_mode_forward_keeps_the_padded_layout():
    """Dropout on: the forward is the padded one, bit for bit with the same
    generator, and plans nothing."""
    cfg = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    enc = E.AnceEncoder.from_jax_params(init_params_numpy(cfg, seed=1), cfg, "cpu", plain=True)
    ids, mask = _batch(cfg, B=4, L=16)
    x, m = torch.from_numpy(ids), torch.from_numpy(mask)
    _zero_pack_counts()
    got = enc(x, m, dropout=torch.Generator().manual_seed(7), trainable=True)
    want = E._encode([enc], x, m, dropout=torch.Generator().manual_seed(7), trainable=True)
    assert torch.equal(got, want)
    assert pack.COUNTS["forwards"] == 0


def test_pack_counts_after_a_known_batch():
    cfg = _cfg()
    enc = E.AnceEncoder.from_jax_params(_params(cfg, False), cfg, "cpu")
    mask = np.zeros((3, 40), np.int32)
    mask[0, :5] = 1
    mask[1, :40] = 1
    mask[2, [0, 3]] = 1
    ids = np.where(mask == 1, 7, 0).astype(np.int32)
    _zero_pack_counts()
    with torch.inference_mode():
        enc(torch.from_numpy(ids), torch.from_numpy(mask), host_mask=mask)
        assert pack.COUNTS == {"forwards": 1, "slots": 120, "rows": 5 + 40 + 4, "valid": 47,
                               "plan_reads": 0}
        enc(torch.from_numpy(ids), torch.from_numpy(mask))  # no host mask: read
    assert pack.COUNTS["plan_reads"] == 1 and pack.COUNTS["forwards"] == 2


def _examples(cfg, n, L, seed=0):
    ids, mask = _batch(cfg, B=n, L=L, seed=seed)
    return [{"sample_id": f"q{i}", "q": ids[i], "q_mask": mask[i]} for i in range(n)]


@pytest.mark.parametrize("mesh, n", [(None, 11), ((2, 1), 11), ((1, 2), 11),
                                     (None, 4 * PIPELINE_DEPTH + 3)])
def test_encode_batches_plans_from_the_host_mask(mesh, n):
    """Through ``encode_batches`` (one device, a dp mesh, a tp group) every
    forward is planned from the batch's host mask: no mask is read.  Over
    more batches than ``PIPELINE_DEPTH`` the rows and ids keep their
    order."""
    cfg = _cfg("bfloat16")
    params = _params(cfg, True)
    examples = _examples(cfg, n, 48)
    if mesh is None:
        fn, m = E.AnceEncoder.from_jax_params(params, cfg, "cpu"), None
    else:
        m = make_mesh(dp=mesh[0], tp=mesh[1], devices=["cpu"] * (mesh[0] * mesh[1]))
        fn = shard_params(m, params, tp=mesh[1] > 1, cfg=cfg)
    _zero_pack_counts()
    embs, ids = encode_batches(fn, batch_iter(examples, 4), "q", "q_mask", m)
    assert pack.COUNTS["plan_reads"] == 0 and pack.COUNTS["forwards"] >= 3
    assert ids == [e["sample_id"] for e in examples]
    one = E.AnceEncoder.from_jax_params(params, cfg, "cpu")
    with torch.inference_mode():
        x = torch.from_numpy(np.stack([e["q"] for e in examples]))
        mk = np.stack([e["q_mask"] for e in examples])
        ref = E._encode([one], x, torch.from_numpy(mk)).numpy()
    # the head's float product rounds over each batch's row count
    assert np.abs(embs - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("mesh", [None, (2, 1)])
def test_encode_corpus_plans_from_the_host_mask(tmp_path, mesh):
    cfg = _cfg()
    enc = E.AnceEncoder.from_jax_params(_params(cfg, False), cfg, "cpu")
    rng = np.random.default_rng(0)
    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=32)
    for i in range(21):
        w.add(i, rng.integers(3, cfg.vocab_size, int(rng.integers(2, 33))).tolist())
    w.finalize()
    m = None if mesh is None else make_mesh(dp=2, tp=1, devices=["cpu"] * 2)
    _zero_pack_counts()
    store = encode_corpus(TokenizedCorpus(str(tmp_path / "c")), enc, str(tmp_path / "b"),
                          batch_size=8, device="cpu", mesh=m)
    assert pack.COUNTS["plan_reads"] == 0 and pack.COUNTS["forwards"] >= 3
    assert pack.COUNTS["rows"] < pack.COUNTS["slots"]
    emb, offs = store.read_block(0)
    assert len(offs) == 21 and np.isfinite(np.asarray(emb)).all()


@pytest.mark.parametrize("width", [32, 128])
@pytest.mark.parametrize("dtype, int8", [("float32", False), ("float32", True),
                                         ("bfloat16", True)], ids=["f32", "int8_f32", "int8_bf16"])
def test_a_short_last_batch_is_encoded_as_its_own_rows(tmp_path, dtype, int8, width):
    """21 passages in batches of 8: the last batch runs its 5 rows, with no
    padding, and stores the rows a batch padded to 8 (fully masked rows
    whose first position is set) gives them; ``slots`` counts the 21 rows
    the tower ran.  At the tiny width bit for bit; at width 128 the float
    head's product over the pooled rows rounds over their count (5 or 8)
    on the CPU, within 1e-6 of the largest |element|."""
    cfg = ModelConfig.tiny(vocab_size=512, dtype=dtype) if width == 32 else _cfg(dtype)
    enc = E.AnceEncoder.from_jax_params(_params(cfg, int8), cfg, "cpu")
    rng = np.random.default_rng(1)
    L = 32
    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=L)
    for i in range(21):
        w.add(i, rng.integers(3, cfg.vocab_size, int(rng.integers(2, L + 1))).tolist())
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "c"))
    _zero_pack_counts()
    store = encode_corpus(corpus, enc, str(tmp_path / "b"), batch_size=8, device="cpu")
    assert pack.COUNTS["forwards"] == 3 and pack.COUNTS["slots"] == 21 * L
    want = []
    with torch.inference_mode():
        for _, ids, mask in corpus.batches(8):
            n = len(ids)
            ids = np.concatenate([ids, np.zeros((8 - n, L), np.int32)])
            mask = np.concatenate([mask, np.zeros((8 - n, L), np.int32)])
            mask[n:, 0] = 1
            want.append(enc(torch.from_numpy(ids), torch.from_numpy(mask),
                            host_mask=mask).float().numpy()[:n])
    emb, offs = store.read_block(0)
    want = np.concatenate(want)
    np.testing.assert_array_equal(np.asarray(offs), np.arange(21))
    np.testing.assert_array_equal(np.asarray(emb)[:16], want[:16])  # the whole batches
    tol = 0.0 if width == 32 else 1e-6 * np.abs(want).max()
    assert np.abs(np.asarray(emb) - want).max() <= tol


def _train_batch(cfg, variant, B, seed=0):
    """A ``collate()``-shaped batch of ragged rows (numpy, as the loader
    gives it); "ranking" carries three negatives a row."""
    rng = np.random.default_rng(seed)
    R = 3

    def toks(shape):
        lens = rng.integers(1, shape[-1] + 1, shape[:-1])
        mask = (np.arange(shape[-1]) < lens[..., None]).astype(np.int32)
        return rng.integers(4, cfg.vocab_size, shape).astype(np.int32) * mask, mask

    if variant == "ranking":
        fields = (("conv_qa", (B, 12)), ("pos_docs", (B, 9)), ("neg_docs", (B, R, 9)))
    else:
        fields = tuple((k, (B, 12 if k == "conv_qp" else 9)) for k in (
            "conv_qp", "pos_docs", "neg_docs", "pseudo_prepos_docs", "prepos_neg_docs"))
    b = {}
    for key, shape in fields:
        b[key], b[f"{key}_mask"] = toks(shape)
    b["valid"] = np.ones(B, np.int32)
    if variant == "ranking":
        b["num_negs"] = rng.integers(1, R + 1, B).astype(np.int32)
    else:
        b["has_pseudo_prepos"] = np.ones(B, np.int32)
        b["has_prepos_neg"] = rng.integers(0, 2, B).astype(np.int32)
    return b


@pytest.mark.parametrize("variant,dp", [("prepos", 1), ("prepos", 2), ("ranking", 2)])
def test_train_step_packs_the_frozen_towers_from_the_host_masks(variant, dp, monkeypatch):
    """``make_train_step`` on a dp mesh (5 rows over 2 slots: a short slice
    padded with copies of the first row): the frozen towers' forwards plan
    from the batch's host masks (no mask is read back, so no host sync);
    the trained tower (dropout on) plans nothing; and the loss is, bit for
    bit, the one of the same step whose frozen towers read their masks."""
    cfg = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    tcfg = TrainConfig(accumulation_steps=1, learning_rate=1e-3, is_pseudo_prepos=True,
                       is_prepos_neg=True)
    key = "conv_qa" if variant == "ranking" else "conv_qp"
    batch = _train_batch(cfg, variant, B=5)

    def run():
        opt = T.make_optimizer(tcfg, 10)
        step = T.make_train_step(make_mesh(dp=dp, tp=1, devices=["cpu"] * dp), cfg, tcfg, opt,
                                 loss_variant=variant, query_key=key)
        state = T.init_train_state(
            E.AnceEncoder.from_jax_params(init_params_numpy(cfg, 0), cfg, "cpu"), opt, seed=5)
        frozen = T.build_frozen_encoder(init_params_numpy(cfg, 1), cfg, tcfg, "cpu")
        _zero_pack_counts()
        _, loss = step(state, frozen, batch)
        return loss, dict(pack.COUNTS)

    loss, counts = run()
    n_fields = 2 if variant == "ranking" else 4
    assert counts["plan_reads"] == 0 and counts["forwards"] == n_fields * dp
    assert counts["rows"] < counts["slots"]
    monkeypatch.setattr(T, "_host_masks", lambda b: {})
    read_loss, read_counts = run()
    assert read_counts["plan_reads"] == n_fields * dp
    assert {k: v for k, v in read_counts.items() if k != "plan_reads"} == \
        {k: v for k, v in counts.items() if k != "plan_reads"}
    assert torch.isfinite(loss) and torch.equal(loss, read_loss)


def test_ivf_geometry_check_embeds_without_reading_masks():
    cfg = _cfg()
    enc = E.AnceEncoder.from_jax_params(_params(cfg, False), cfg, "cpu")
    _zero_pack_counts()
    emb = embed_corpus(enc, 10, 16, 4, batch=4)
    assert emb.shape == (10, cfg.embedding_dim) and np.isfinite(emb).all()
    assert pack.COUNTS["plan_reads"] == 0 and pack.COUNTS["forwards"] == 3


def test_takes_host_mask():
    cfg = _cfg()
    enc = E.AnceEncoder.from_jax_params(_params(cfg, False), cfg, "cpu")
    assert pack.takes_host_mask(enc)
    assert pack.takes_host_mask(lambda x, m, **kw: x)
    assert not pack.takes_host_mask(lambda x, m: x)
    assert not pack.takes_host_mask(torch.nn.Linear(2, 2))
