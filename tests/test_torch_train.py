"""Training in the PyTorch port (haconvdr_torch/train/, the encoder's train
mode, models/convert.params_to_jax) against the JAX package's trainer on
the same numpy params and batches.

Pass conditions: losses equal within 1e-5 at every micro step, and after
three accumulated, clipped, decayed updates the port's params within
rtol 2e-4, atol 2e-6 of JAX's (the bound of tests/test_train.py:230).
With int8 frozen towers (a bfloat16 carry) both packages round the
frozen embeddings differently: tests/test_torch_encoder_int8.py holds
such towers to 0.03 per element, which moves the losses by up to a few
hundredths (measured 0.017), so the losses are held to 0.05.  The
gradients of the first micro step and the update the three steps made
(params - initial params) are held to JAX's leaf by leaf, as
||ours - jax|| / ||jax||: within INT8_GRAD_REL = 0.1 and
INT8_UPDATE_REL = 0.2.  The int8 rounding alone moves JAX's own
gradients by up to 0.023 and its update by up to 0.048 of their norms
(JAX int8 against JAX float frozen towers, these configs); the port sits
at up to 0.025 and 0.073, and an update of the wrong sign would read 2.
The key biases are left out: their gradient is zero in exact arithmetic
(softmax ignores a per-row constant), so only rounding noise moves them.
The schedule, the clip and AdamW are held against optax on given
gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from haconvdr_tpu.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from haconvdr_tpu.models import encoder as jenc
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.train import loss as jloss
from haconvdr_tpu.train import trainer as jtrain
from haconvdr_torch.config import ModelConfig, TrainConfig
from haconvdr_torch.models.convert import init_params_numpy, params_from_jax, params_to_jax
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.ops import flash_attention as fa
from haconvdr_torch.parallel.mesh import batch_slices, make_mesh as torch_mesh
from haconvdr_torch.train import loss as tloss
from haconvdr_torch.train.trainer import (
    Trainer,
    build_frozen_encoder,
    decay_mask,
    init_train_state,
    linear_warmup_decay_schedule,
    make_optimizer,
    make_train_step,
)

TOTAL = 10  # schedule length: warmup 2 updates (lr(0) = 0), then decay
INT8_GRAD_REL, INT8_UPDATE_REL = 0.1, 0.2


def _tree_close(a, b, **kw):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **kw)


# ---------------------------------------------------------------------------
# converters, losses, optimizer pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True])
def test_params_to_jax_inverts_params_from_jax(stacked):
    params = init_params_numpy(ModelConfig.tiny(), seed=4)
    back = params_to_jax(params_from_jax(params), stacked=stacked)
    want = jenc.stack_layer_params(params) if stacked else params
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    _tree_close(back, want, rtol=0, atol=0)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    B, R, D = 6, 3, 8
    q, pos, neg, pseudo, prepos = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(5))
    negs = rng.standard_normal((B, R, D)).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0], np.int32)
    has_p = np.array([1, 0, 1, 1, 0, 1], np.int32)
    has_n = np.array([0, 1, 1, 0, 1, 1], np.int32)
    neg_valid = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]] * 2, np.int32)
    t, j = torch.from_numpy, jnp.asarray
    cases = [
        (tloss.ranking_loss(t(q), t(pos), t(neg), t(valid)),
         jloss.ranking_loss(j(q), j(pos), j(neg), j(valid))),
        (tloss.ranking_loss(t(q), t(pos), t(negs), t(valid), t(neg_valid)),
         jloss.ranking_loss(j(q), j(pos), j(negs), j(valid), j(neg_valid))),
        (tloss.ranking_loss_prepos(t(q), t(pos), t(neg), t(pseudo), t(prepos), t(has_p),
                                   t(has_n), alpha=0.7, valid=t(valid)),
         jloss.ranking_loss_prepos(j(q), j(pos), j(neg), j(pseudo), j(prepos), j(has_p),
                                   j(has_n), alpha=0.7, valid=j(valid))),
        (tloss.ranking_loss_prepos(t(q), t(pos), t(neg), is_pseudo_prepos=False,
                                   is_prepos_neg=False),
         jloss.ranking_loss_prepos(j(q), j(pos), j(neg), is_pseudo_prepos=False,
                                   is_prepos_neg=False)),
        (tloss.kd_loss(t(q), t(pos)), jloss.kd_loss(j(q), j(pos))),
    ]
    for ours, ref in cases:
        assert abs(float(ours) - float(ref)) < 1e-5


def test_schedule_matches_jax():
    ours = linear_warmup_decay_schedule(3e-4, 4, 20)
    ref = jtrain.linear_warmup_decay_schedule(3e-4, 4, 20)
    for s in range(0, 23):
        assert ours(s) == np.float32(ref(s)), s
    assert ours(0) == 0.0


def test_decay_mask_matches_jax():
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=1)
    jmask = jtrain._no_decay_mask(params)
    as_arrays = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32), params, jmask
    )
    want = {k: bool(v.all()) for k, v in params_from_jax(as_arrays).items()}
    assert decay_mask(AnceEncoder.from_jax_params(params, cfg, "cpu")) == want


def _grads_like(model, rng, scale):
    return {n: torch.from_numpy((rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32))
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("max_norm", [1e9, 0.5])
def test_clip_and_adamw_match_optax_on_given_gradients(max_norm):
    """Three updates from given gradients: the clip (engaged or not),
    Adam's moments and bias correction, decoupled decay on the masked
    params, and the warmup/decay learning rate."""
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=2)
    tcfg = TrainConfig(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=max_norm,
                       num_warmup_portion=0.2)
    model = AnceEncoder.from_jax_params(params, cfg, "cpu")
    opt = make_optimizer(tcfg, TOTAL)
    state = opt.init(model)
    jopt = jtrain.make_optimizer(JTrainConfig(**dataclasses.asdict(tcfg)), TOTAL)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = _grads_like(model, rng, 0.05)
        jgrads = jax.tree_util.tree_map(jnp.asarray, params_to_jax(grads))
        norm = float(opt.clip_({k: v.clone() for k, v in grads.items()}))
        jclipped, _ = optax.clip_by_global_norm(max_norm).update(jgrads, optax.EmptyState())
        clipped = {k: v.clone() for k, v in grads.items()}
        opt.clip_(clipped)
        _tree_close(params_to_jax(clipped), jclipped, rtol=1e-6, atol=1e-9)
        assert (norm >= max_norm) == (max_norm < 1e9)
        opt.apply_(model, grads, state)
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _tree_close(params_to_jax(model.state_dict()), jparams, rtol=1e-6, atol=1e-7)
    assert state.count == 3


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

def _toks(rng, vocab, shape, min_len=2):
    ids = rng.integers(4, vocab, size=shape).astype(np.int32)
    lens = rng.integers(min_len, shape[-1] + 1, size=shape[:-1])
    mask = (np.arange(shape[-1]) < lens[..., None]).astype(np.int32)
    return ids * mask, mask


def _batches(cfg, variant, n, seed, B=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if variant == "ranking":
            R = 3
            q, qm = _toks(rng, cfg.vocab_size, (B, 10))
            p, pm = _toks(rng, cfg.vocab_size, (B, 7))
            ng, nm = _toks(rng, cfg.vocab_size, (B, R, 7))
            out.append({"conv_qa": q, "conv_qa_mask": qm, "pos_docs": p, "pos_docs_mask": pm,
                        "neg_docs": ng, "neg_docs_mask": nm,
                        "num_negs": rng.integers(1, R + 1, B).astype(np.int32),
                        "valid": np.ones(B, np.int32)})
            continue
        b = {}
        for key, L in (("conv_qp", 12), ("pos_docs", 7), ("neg_docs", 7),
                       ("pseudo_prepos_docs", 7), ("prepos_neg_docs", 7)):
            b[key], b[f"{key}_mask"] = _toks(rng, cfg.vocab_size, (B, L))
        b["has_pseudo_prepos"] = rng.integers(0, 2, B).astype(np.int32)
        b["has_prepos_neg"] = rng.integers(0, 2, B).astype(np.int32)
        b["valid"] = np.array([1] * (B - 1) + [0], np.int32)  # a loader-padded row
        out.append(b)
    return out


def _run_jax(cfg, tcfg, params, frozen, batches, variant, query_key):
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jt = JTrainConfig(**dataclasses.asdict(tcfg))
    opt = jtrain.make_optimizer(jt, TOTAL)
    step = jtrain.make_train_step(make_mesh(dp=8), jcfg, jt, opt, loss_variant=variant,
                                  query_key=query_key)
    state = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), opt)
    fz = jax.tree_util.tree_map(jnp.asarray, frozen)
    if tcfg.frozen_dtype == "int8":
        fz = jenc.quantize_encoder_params(fz)
    losses, first_grads = [], None
    for b in batches:
        state, loss = step(state, fz, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
        if first_grads is None:
            first_grads = jax.tree_util.tree_map(np.asarray, state.accum_grads)
    assert int(state.global_step) == 3
    return losses, jax.tree_util.tree_map(np.asarray, state.params), first_grads


def _run_port(cfg, tcfg, params, frozen_params, batches, variant, query_key, mesh=None):
    """The port's step on ``mesh`` (default one CPU slot): each micro
    batch of B rows runs one trained forward and backward a dp slot that
    holds rows."""
    mesh = mesh or torch_mesh(devices=["cpu"])
    opt = make_optimizer(tcfg, TOTAL)
    norms = []
    clip = opt.clip_
    opt.clip_ = lambda g: norms.append(float(clip(g))) or norms[-1]
    step = make_train_step(mesh, cfg, tcfg, opt, loss_variant=variant, query_key=query_key)
    state = init_train_state(AnceEncoder.from_jax_params(params, cfg, "cpu"), opt)
    frozen = build_frozen_encoder(frozen_params, cfg, tcfg, "cpu")
    before = {k: v.clone() for k, v in frozen.state_dict().items()}
    for key in fa.COUNTS:
        fa.COUNTS[key] = 0
    losses, first_grads = [], None
    for b in batches:
        state, loss = step(state, frozen, b)
        losses.append(float(loss))
        if first_grads is None:
            first_grads = params_to_jax({k: v.clone() for k, v in state.accum_grads.items()})
    assert state.global_step == 3 and state.micro_step == 0 and state.opt_state.count == 3
    assert len(norms) == 3 and all(n > tcfg.max_grad_norm for n in norms)  # the clip engaged
    # one trained forward and backward a slot with rows per micro step: the
    # flash plain twins
    B = batches[0]["valid"].shape[0]
    slots = sum(e > a for a, e in batch_slices(B, mesh.shape["dp"]))
    n = len(batches) * cfg.num_hidden_layers * slots
    assert fa.COUNTS == {"fwd": 0, "bwd": 0, "plain_fwd": n, "plain_bwd": n}
    for k, v in frozen.state_dict().items():  # the frozen tower is unchanged
        assert torch.equal(v, before[k]), k
    return losses, params_to_jax(state.model.state_dict()), first_grads


def _leaf_rel(ours, ref, select):
    """Per selected leaf, ||ours - ref|| / ||ref||."""
    return [float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))
            for a, b, keep in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref),
                                  select) if keep]


@pytest.mark.parametrize("frozen_dtype", ["", "int8"])
@pytest.mark.parametrize("variant, query_key", [("prepos", "conv_qp"), ("ranking", "conv_qa")])
def test_train_step_matches_jax_after_three_updates(variant, query_key, frozen_dtype):
    compare_with_jax(variant, query_key, frozen_dtype)


def compare_with_jax(variant, query_key, frozen_dtype, mesh=None):
    """Six micro batches of 8 (accumulation 2: three updates) through the
    port's step on ``mesh`` (default one CPU slot) and JAX's on
    ``make_mesh(dp=8)``, held to the module docstring's bounds."""
    cfg = ModelConfig.tiny()
    tcfg = TrainConfig(
        accumulation_steps=2, learning_rate=1e-3, weight_decay=0.05, max_grad_norm=0.05,
        num_warmup_portion=0.2, is_pseudo_prepos=True, is_prepos_neg=True, alpha=0.7,
        frozen_dtype=frozen_dtype,
    )
    params, frozen = init_params_numpy(cfg, seed=0), init_params_numpy(cfg, seed=1)
    batches = _batches(cfg, variant, 6, seed=11)
    ref_losses, ref_params, ref_grads = _run_jax(cfg, tcfg, params, frozen, batches, variant,
                                                 query_key)
    losses, ours, grads = _run_port(cfg, tcfg, params, frozen, batches, variant, query_key,
                                    mesh)
    if frozen_dtype == "":
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
        _tree_close(grads, ref_grads, rtol=2e-4, atol=2e-6)
        _tree_close(ours, ref_params, rtol=2e-4, atol=2e-6)
    else:
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=0.05)
        norms = [np.linalg.norm(g) for g in jax.tree_util.tree_leaves(ref_grads)]
        select = [n > 1e-6 * max(norms) for n in norms]  # all but the key biases
        assert sum(select) == len(select) - cfg.num_hidden_layers
        assert max(_leaf_rel(grads, ref_grads, select)) <= INT8_GRAD_REL
        update = jax.tree_util.tree_map(np.subtract, ours, params)
        ref_update = jax.tree_util.tree_map(np.subtract, ref_params, params)
        assert max(_leaf_rel(update, ref_update, select)) <= INT8_UPDATE_REL
    moved = max(np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(ours),
                                                    jax.tree_util.tree_leaves(params)))
    assert moved > 1e-4  # the updates did move the params


def test_trainable_int8_tower_raises():
    cfg = ModelConfig.tiny(dtype="bfloat16")
    from haconvdr_torch.models.encoder import quantize_encoder_params

    enc = AnceEncoder.from_jax_params(quantize_encoder_params(init_params_numpy(cfg)), cfg, "cpu")
    ids = torch.ones(2, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="inference-only"):
        enc(ids, torch.ones_like(ids), trainable=True)


def _dropout_grads(remat, seed=5):
    cfg = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                           remat=remat)
    enc = AnceEncoder.from_jax_params(init_params_numpy(cfg, seed=3), cfg, "cpu")
    ids, mask = _toks(np.random.default_rng(9), cfg.vocab_size, (4, 9))
    w = torch.from_numpy(np.random.default_rng(10).standard_normal((4, cfg.embedding_dim)))
    for key in fa.COUNTS:
        fa.COUNTS[key] = 0
    out = enc(torch.from_numpy(ids), torch.from_numpy(mask),
              dropout=torch.Generator().manual_seed(seed), trainable=True)
    (out * w.float()).sum().backward()
    counts = dict(fa.COUNTS)
    return out.detach(), {n: p.grad for n, p in enc.named_parameters()}, counts


def test_remat_gives_the_same_gradients_with_dropout_on():
    out, grads, counts = _dropout_grads(False)
    assert counts == {"fwd": 0, "bwd": 0, "plain_fwd": 2, "plain_bwd": 2}
    other, _, _ = _dropout_grads(False, seed=6)
    assert not torch.equal(out, other)  # the generator does drive dropout
    for remat, fwd in (("mlp", 2), (True, 4)):  # a whole-layer remat reruns attention
        o, g, c = _dropout_grads(remat)
        assert c == {"fwd": 0, "bwd": 0, "plain_fwd": fwd, "plain_bwd": 2}
        torch.testing.assert_close(o, out, rtol=0, atol=0)
        for n in grads:
            torch.testing.assert_close(g[n], grads[n], rtol=1e-6, atol=1e-7, msg=n)


def test_trainer_fit_smoke(tmp_path):
    cfg = ModelConfig.tiny()
    tcfg = TrainConfig(
        num_train_epochs=2, per_device_train_batch_size=8, accumulation_steps=2,
        learning_rate=1e-3, is_pseudo_prepos=False, is_prepos_neg=False, print_steps=0,
        frozen_dtype="int8",
    )
    rng = np.random.default_rng(4)
    examples = [
        {
            "sample_id": f"s{i}",
            "conv_qp": rng.integers(4, cfg.vocab_size, 6).tolist(), "conv_qp_mask": [1] * 6,
            "pos_docs": rng.integers(4, cfg.vocab_size, 5).tolist(), "pos_docs_mask": [1] * 5,
            "neg_docs": rng.integers(4, cfg.vocab_size, 5).tolist(), "neg_docs_mask": [1] * 5,
        }
        for i in range(16)
    ]
    saves = []
    trainer = Trainer(torch_mesh(devices=["cpu"]), cfg, tcfg, save_fn=lambda m, s: saves.append(s),
                      state_ckpt_dir=str(tmp_path / "ckpt"), state_ckpt_every=2)
    state, best = trainer.fit(init_params_numpy(cfg, 0), init_params_numpy(cfg, 1), examples)
    assert np.isfinite(best) and len(saves) >= 1
    assert state.global_step == 2 and state.micro_step == 0
    from haconvdr_torch.train.checkpoint import latest_step

    assert latest_step(str(tmp_path / "ckpt")) == 4


def test_trainer_metrics_log_the_jax_trainers_events(tmp_path):
    """``Trainer(metrics=MetricsLogger(path))`` in both packages on the same
    examples and seed (dropout off, the JAX Trainer on a one-device mesh so
    both take batches of 4): the same train_step events (keys, epochs,
    micro steps), losses within 2e-4."""
    import json

    from haconvdr_tpu.utils.telemetry import MetricsLogger as JMetricsLogger
    from haconvdr_torch.utils.telemetry import MetricsLogger

    cfg = ModelConfig.tiny()
    tcfg = TrainConfig(
        num_train_epochs=2, per_device_train_batch_size=4, accumulation_steps=2,
        learning_rate=1e-3, is_pseudo_prepos=False, is_prepos_neg=False, print_steps=0,
    )
    rng = np.random.default_rng(6)
    examples = [
        {
            "sample_id": f"s{i}",
            "conv_qp": rng.integers(4, cfg.vocab_size, 6).tolist(), "conv_qp_mask": [1] * 6,
            "pos_docs": rng.integers(4, cfg.vocab_size, 5).tolist(), "pos_docs_mask": [1] * 5,
            "neg_docs": rng.integers(4, cfg.vocab_size, 5).tolist(), "neg_docs_mask": [1] * 5,
        }
        for i in range(12)
    ]
    params, frozen = init_params_numpy(cfg, 0), init_params_numpy(cfg, 1)
    events = {}
    for name, logger_cls, trainer in (
        ("jax", JMetricsLogger, lambda m: jtrain.Trainer(
            make_mesh(devices=jax.devices()[:1]), JModelConfig(**dataclasses.asdict(cfg)),
            JTrainConfig(**dataclasses.asdict(tcfg)), metrics=m)),
        ("torch", MetricsLogger, lambda m: Trainer(torch_mesh(devices=["cpu"]), cfg, tcfg,
                                                   metrics=m)),
    ):
        metrics = logger_cls(str(tmp_path / f"{name}.jsonl"))
        trainer(metrics).fit(params, frozen, examples)
        metrics.close()
        events[name] = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
    ours, ref = events["torch"], events["jax"]
    assert len(ours) == len(ref) == 6  # 2 epochs x 3 batches
    for got, want in zip(ours, ref):
        assert got.keys() == want.keys() == {"t", "event", "epoch", "micro_step", "loss"}
        assert (got["event"], got["epoch"], got["micro_step"]) == (
            want["event"], want["epoch"], want["micro_step"])
    assert [e["micro_step"] for e in ours] == list(range(1, 7))
    np.testing.assert_allclose([e["loss"] for e in ours], [e["loss"] for e in ref],
                               rtol=2e-4, atol=2e-4)


def test_metrics_logger_and_timer(tmp_path):
    """The port's telemetry copy writes what tests/test_mine.py's
    test_metrics_logger holds the JAX one to; a logger with no path is a
    no-op."""
    import json

    from haconvdr_torch.utils.telemetry import MetricsLogger

    path = str(tmp_path / "sub" / "m.jsonl")
    m = MetricsLogger(path, flush_every=1)
    m.log("train_step", loss=1.5, step=3)
    m.close()
    recs = [json.loads(line) for line in open(path)]
    assert len(recs) == 1
    assert recs[0]["event"] == "train_step" and recs[0]["loss"] == 1.5 and recs[0]["step"] == 3
    m2 = MetricsLogger("")
    m2.log("x")
    m2.close()
