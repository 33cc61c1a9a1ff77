"""Train-state checkpoints of the PyTorch port (haconvdr_torch/train/
checkpoint.py): a run saved at a micro step inside an accumulation window,
restored into a fresh state and continued, ends with exactly the params
of the uninterrupted run, with dropout on (the generator state is part of
the checkpoint)."""

import numpy as np
import pytest
import torch

from haconvdr_torch.config import ModelConfig, TrainConfig
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.parallel.mesh import make_mesh
from haconvdr_torch.train.checkpoint import latest_step, restore_train_state, save_train_state
from haconvdr_torch.train.trainer import (
    build_frozen_encoder,
    init_train_state,
    make_optimizer,
    make_train_step,
)

CFG = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
TCFG = TrainConfig(accumulation_steps=2, learning_rate=1e-3, weight_decay=0.01,
                   num_warmup_portion=0.0, is_pseudo_prepos=False, is_prepos_neg=False)


def _batches(n, B=4):
    rng = np.random.default_rng(0)

    def toks(L):
        return rng.integers(4, CFG.vocab_size, (B, L)).astype(np.int32), np.ones((B, L), np.int32)

    out = []
    for _ in range(n):
        (q, qm), (p, pm), (ng, nm) = toks(8), toks(6), toks(6)
        out.append({"conv_qp": q, "conv_qp_mask": qm, "pos_docs": p, "pos_docs_mask": pm,
                    "neg_docs": ng, "neg_docs_mask": nm, "valid": np.ones(B, np.int32)})
    return out


def _fresh():
    opt = make_optimizer(TCFG, total_steps=20)
    step = make_train_step(make_mesh(devices=["cpu"]), CFG, TCFG, opt)
    state = init_train_state(AnceEncoder.from_jax_params(init_params_numpy(CFG, 0), CFG, "cpu"),
                             opt, seed=7)
    return step, state, build_frozen_encoder(init_params_numpy(CFG, 1), CFG, TCFG, "cpu")


@pytest.mark.parametrize("k", [3, 4])
def test_resume_equals_an_uninterrupted_run(tmp_path, k):
    batches = _batches(6)
    step, state, frozen = _fresh()
    losses = [float(step(state, frozen, b)[1]) for b in batches]
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}

    step, state, frozen = _fresh()
    for b in batches[:k]:
        step(state, frozen, b)
    save_train_state(str(tmp_path), k, state)
    assert latest_step(str(tmp_path)) == k
    assert state.micro_step == k % 2

    step, state, frozen = _fresh()
    state = restore_train_state(str(tmp_path), state)
    assert (state.micro_step, state.global_step, state.opt_state.count) == (k % 2, k // 2, k // 2)
    resumed = [float(step(state, frozen, b)[1]) for b in batches[k:]]
    assert resumed == losses[k:]
    for n, p in state.model.named_parameters():
        assert torch.equal(p, want[n]), n


def test_dropout_draws_differ_between_steps_and_old_checkpoints_rotate(tmp_path):
    step, state, frozen = _fresh()
    b = _batches(1)[0]
    a1, a2 = float(step(state, frozen, b)[1]), float(step(state, frozen, b)[1])
    assert a1 != a2  # a fresh dropout draw each micro step
    for s in range(1, 6):
        save_train_state(str(tmp_path), s, state, max_to_keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "state_0000000004.pt", "state_0000000005.pt"]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"), state)
