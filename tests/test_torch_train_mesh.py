"""Training on a mesh in the PyTorch port (haconvdr_torch/train/trainer.py:
make_train_step(mesh, ...), Trainer(mesh, ...), checkpoints across meshes,
rows 11-12's row offset) against the JAX package's data-parallel trainer
and against the port's own one-slot step.

Tolerances:
  * against JAX (dropout off, eight CPU slots against make_mesh(dp=8)):
    tests/test_torch_train.py's bounds (losses within 1e-5, gradients and
    params within rtol 2e-4, atol 2e-6; int8 frozen towers as documented
    there);
  * the port on a mesh against the port on one slot, dropout on: loss and
    parameters after two updates within 1e-5 (the same masks, the same
    loss over the whole batch; only float sums over the slots' rows run in
    another order);
  * rows 11-12 with an offset against rows a:b of the whole-batch call:
    bit for bit (each (b, h) tile is computed on its own); the offset-0
    call against JAX's kernel: tests/test_torch_flash_attention.py's
    bounds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from haconvdr_tpu.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from haconvdr_tpu.parallel.mesh import make_mesh as jax_mesh
from haconvdr_tpu.train import trainer as jtrain
from haconvdr_torch.config import ModelConfig, TrainConfig
from haconvdr_torch.models.convert import init_params_numpy, params_to_jax
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.ops import flash_attention as fa
from haconvdr_torch.parallel.mesh import make_mesh
from haconvdr_torch.train.checkpoint import restore_train_state, save_train_state
from haconvdr_torch.train.trainer import (
    Trainer,
    batch_to_device,
    build_frozen_encoder,
    embed_batch,
    embeddings_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
)

from test_torch_flash_attention import _close, _inputs, _jax
from test_torch_train import _batches, _tree_close, compare_with_jax

DROP = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
TCFG = TrainConfig(accumulation_steps=1, learning_rate=1e-3, weight_decay=0.01,
                   num_warmup_portion=0.0, max_grad_norm=1.0, is_pseudo_prepos=True,
                   is_prepos_neg=True, alpha=0.7)


def cpu_mesh(dp, tp=1, devices=None):
    return make_mesh(dp=dp, tp=tp, devices=devices or ["cpu"] * (dp * tp))


@pytest.mark.parametrize("frozen_dtype", ["", "int8"])
@pytest.mark.parametrize("variant, query_key", [("prepos", "conv_qp"), ("ranking", "conv_qa")])
def test_mesh_step_matches_jax_data_parallel_after_three_updates(variant, query_key,
                                                                 frozen_dtype):
    """Eight CPU slots (one row each) against JAX's make_mesh(dp=8) step;
    "ranking" batches carry three negatives a row (multi-negative)."""
    compare_with_jax(variant, query_key, frozen_dtype, mesh=cpu_mesh(8))


def _run(mesh, batches, cfg=DROP, tcfg=TCFG, variant="prepos", seed=7):
    """Losses, final state of the port's step on ``mesh`` from one state
    and one dropout generator."""
    opt = make_optimizer(tcfg, 10)
    step = make_train_step(mesh, cfg, tcfg, opt, loss_variant=variant)
    state = init_train_state(
        AnceEncoder.from_jax_params(init_params_numpy(cfg, 0), cfg, mesh.first), opt, seed=seed)
    frozen = build_frozen_encoder(init_params_numpy(cfg, 1), cfg, tcfg, mesh.first)
    losses, replicas_equal = [], []
    for b in batches:
        state, loss = step(state, frozen, b)
        losses.append(float(loss))
        replicas_equal.append(all(
            torch.equal(p, q) for r in state.replicas[1:]
            for (_, p), (_, q) in zip(state.model.named_parameters(), r.named_parameters())))
    return losses, state, replicas_equal


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _assert_params_close(a, b, atol):
    assert a.keys() == b.keys()
    for n in a:
        torch.testing.assert_close(a[n], b[n], rtol=0, atol=atol, msg=n)


@pytest.mark.parametrize("dp, tp", [(8, 1), (2, 2)])
def test_mesh_step_with_dropout_equals_the_one_slot_step(dp, tp):
    """Dropout on (hidden and attention-probs): the slots draw their rows'
    masks of the whole batch, so the mesh step is the one-slot step."""
    batches = _batches(DROP, "prepos", 2, seed=21)
    ref_losses, ref, _ = _run(cpu_mesh(1), batches)
    losses, state, _ = _run(cpu_mesh(dp, tp), batches)
    assert state.global_step == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    _assert_params_close(_params(state), _params(ref), 1e-5)
    # the masks matter: another generator moves the loss
    other, _, _ = _run(cpu_mesh(dp, tp), batches, seed=8)
    assert abs(other[0] - losses[0]) > 1e-4


def test_replicas_stay_bit_identical_after_every_update():
    """Two distinct devices ("cpu" and "cpu:0", two replicas of each tower)
    over four dp slots: the step sums the second replica's gradients into
    the first's buffer, updates once and copies the params back."""
    batches = _batches(DROP, "prepos", 3, seed=22)
    ref_losses, ref, _ = _run(cpu_mesh(1), batches)
    mesh = cpu_mesh(4, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    losses, state, equal = _run(mesh, batches)
    assert len(state.replicas) == 2 and state.replicas[1] is not state.model
    assert equal == [True, True, True]
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    _assert_params_close(_params(state), _params(ref), 1e-5)


def test_shape_padding_rows_stay_out_of_the_loss():
    """A batch of 13 on 4 slots: slices of 4 rows, the last one real row
    and three rows of shape padding; the loss is that of the 13 rows, and
    its gradients, as rows and as in-batch columns alike."""
    tcfg = dataclasses.replace(TCFG, learning_rate=0.0)
    b = _batches(DROP, "prepos", 1, seed=23, B=13)[0]
    ref_losses, ref, _ = _run(cpu_mesh(1), [b], tcfg=tcfg)
    for key in fa.COUNTS:
        fa.COUNTS[key] = 0
    losses, state, _ = _run(cpu_mesh(4), [b], tcfg=tcfg)
    assert fa.COUNTS["plain_fwd"] == 4 * DROP.num_hidden_layers  # four slots of 4 rows
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    # lr 0: the update moved nothing; compare the clipped moments instead
    for n, mu in ref.opt_state.mu.items():
        torch.testing.assert_close(state.opt_state.mu[n], mu, rtol=1e-4, atol=1e-7, msg=n)
    # and the loss is the one-device loss of the batch's 13 rows
    model = AnceEncoder.from_jax_params(init_params_numpy(DROP, 0), DROP, "cpu")
    frozen = build_frozen_encoder(init_params_numpy(DROP, 1), DROP, tcfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    bt = batch_to_device(b, "cpu")
    e = embed_batch(model, frozen, bt, tcfg, dropout=gen)
    direct = float(embeddings_loss(e, bt, tcfg).detach())
    assert abs(direct - losses[0]) <= 1e-5


def _examples(n, cfg, seed):
    rng = np.random.default_rng(seed)
    return [
        {
            "sample_id": f"s{i}",
            "conv_qp": rng.integers(4, cfg.vocab_size, 6).tolist(), "conv_qp_mask": [1] * 6,
            "pos_docs": rng.integers(4, cfg.vocab_size, 5).tolist(), "pos_docs_mask": [1] * 5,
            "neg_docs": rng.integers(4, cfg.vocab_size, 5).tolist(), "neg_docs_mask": [1] * 5,
        }
        for i in range(n)
    ]


def test_trainer_fit_on_eight_slots_matches_jax():
    """Trainer.fit on eight CPU slots against JAX's Trainer on
    make_mesh(dp=8): batches of per_device x 8 = 16, four micro steps, two
    updates, the same best loss and params."""
    cfg = ModelConfig.tiny()
    tcfg = TrainConfig(num_train_epochs=2, per_device_train_batch_size=2, accumulation_steps=2,
                       learning_rate=1e-3, max_grad_norm=0.5, is_pseudo_prepos=False,
                       is_prepos_neg=False, print_steps=0)
    examples = _examples(32, cfg, seed=24)
    params, frozen = init_params_numpy(cfg, 0), init_params_numpy(cfg, 1)
    steps = {}
    jt = jtrain.Trainer(jax_mesh(dp=8), JModelConfig(**dataclasses.asdict(cfg)),
                        JTrainConfig(**dataclasses.asdict(tcfg)),
                        save_fn=lambda p, s: steps.setdefault("jax", []).append(s))
    jstate, jbest = jt.fit(params, frozen, examples)
    tt = Trainer(cpu_mesh(8), cfg, tcfg, save_fn=lambda m, s: steps.setdefault("torch", []).append(s))
    state, best = tt.fit(params, frozen, examples)
    assert state.global_step == int(jstate.global_step) == 2
    assert steps["torch"] == steps["jax"]
    assert abs(best - jbest) <= 1e-5
    _tree_close(params_to_jax(state.model.state_dict()),
                jax.tree_util.tree_map(np.asarray, jstate.params), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("n_to", [1, 8])
def test_checkpoint_saved_on_four_slots_resumes_on_any_mesh(tmp_path, n_to):
    """Save after three micro steps on four slots (accumulation 2: inside a
    window), restore on n_to slots: the state is equal and the next step
    gives the four-slot run's loss and params."""
    tcfg = dataclasses.replace(TCFG, accumulation_steps=2)
    batches = _batches(DROP, "prepos", 4, seed=25)

    def fresh(mesh):
        opt = make_optimizer(tcfg, 10)
        step = make_train_step(mesh, DROP, tcfg, opt)
        state = init_train_state(
            AnceEncoder.from_jax_params(init_params_numpy(DROP, 0), DROP, "cpu"), opt, seed=7)
        return step, state, build_frozen_encoder(init_params_numpy(DROP, 1), DROP, tcfg, "cpu")

    step, state, frozen = fresh(cpu_mesh(4))
    for b in batches[:3]:
        step(state, frozen, b)
    save_train_state(str(tmp_path), 3, state)
    saved = {n: t.clone() for n, t in state.accum_grads.items()}
    _, want_loss = step(state, frozen, batches[3])
    want = _params(state)

    step, state, frozen = fresh(cpu_mesh(n_to))
    state = restore_train_state(str(tmp_path), state)
    assert (state.micro_step, state.global_step, state.opt_state.count) == (1, 1, 1)
    for n, t in saved.items():
        assert torch.equal(state.accum_grads[n], t), n
    _, loss = step(state, frozen, batches[3])
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    _assert_params_close(_params(state), want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_offset_draws_the_whole_batchs_masks(dtype):
    """flash_attention_plain on rows a:b with row_offset=a equals rows a:b
    of the whole-batch call (output and dqkv, bit for bit); offset 0 equals
    JAX's kernel (interpret mode) on the same seed words."""
    B, L, heads, rate, seed = 6, 16, 2, 0.25, (123456789, -987654321)
    qkv, mask, g = _inputs(B, L, heads, dtype, seed=3)
    tdt = getattr(torch, dtype)

    def run(rows, offset):
        x = torch.from_numpy(qkv[rows]).to(tdt).requires_grad_(True)
        out = fa.flash_attention_plain(x, torch.from_numpy(mask[rows]), heads, seed=seed,
                                       drop_rate=rate, row_offset=offset)
        out.backward(torch.from_numpy(g[rows]).to(tdt))
        return out.detach(), x.grad

    whole_out, whole_dq = run(slice(0, B), 0)
    for a, b in ((2, 5), (5, 6)):
        out, dq = run(slice(a, b), a)
        assert torch.equal(out, whole_out[a:b]) and torch.equal(dq, whole_dq[a:b])
    other_out, _ = run(slice(2, 5), 0)  # without the offset: rows 0-2's masks
    assert not torch.equal(other_out, whole_out[2:5])
    ref_out, ref_dq = _jax(qkv, mask, g, heads, seed, rate, dtype)
    _close(whole_out.float().numpy(), ref_out, dtype)
    _close(whole_dq.float().numpy(), ref_dq, dtype)
