"""CLI: contrastive training (counterpart of haconvdr_tpu/cli/train_retrieval.py,
the reference's src/train_HAConvDR_topiocqa.py / train_HAConvDR_qrecc.py /
train_HAConvDR_topiocqa_PRF.py).

Usage: python -m haconvdr_torch.cli.train_retrieval --config cfg.toml
       [data.dataset=topiocqa data.mode=convqp train.learning_rate=1e-5 ...]
       [--device cuda|cpu]

The PRF variant (data.is_PRF=true, with a PRF-merged train file) takes
the expanded dataset (one extra example per pseudo-prepos passage used as
a positive), the plain ranking loss and the PRF checkpoint name, as the
reference's separate _PRF script does (src/train_HAConvDR_topiocqa_PRF.py:
37-41, 81, 146).  The frozen passage tower starts from the same
checkpoint.  The best-loss checkpoint is an HF directory
(``save_hf_checkpoint`` of the trained tower, and the tokenizer) under
``train.model_output_path``.  JAX's CLI stacks the layers for its
scanned train step and unstacks them to save; the port's tower keeps
one module per layer, so neither step is needed.  Training runs on the
mesh of ``--device`` (``cli._args.device_mesh``): every visible card by
default, as JAX's CLI builds ``make_mesh()``, with a global batch of
``per_device_train_batch_size`` x the card count; one slot of the plain
twins with ``--device cpu``.
"""

import logging
import os

from haconvdr_torch.cli._args import device_mesh, pop_device
from haconvdr_torch.config import config_from_argv
from haconvdr_torch.models.convert import params_to_jax
from haconvdr_torch.models.hf_import import load_checkpoint, save_hf_checkpoint
from haconvdr_torch.train.trainer import Trainer
from haconvdr_torch.utils.io import set_seed, setup_logging

logger = logging.getLogger(__name__)

_QUERY_KEY = {"raw": "raw_query", "convq": "conv_q", "convqa": "conv_qa",
              "convqp": "conv_qp", "rewrite": "rewrite"}


def checkpoint_name(cfg) -> str:
    """Reference checkpoint naming: the PRF trainer encodes hard_neg_type /
    is_PRF / PRF_top (src/train_HAConvDR_topiocqa_PRF.py:37-41); the
    standard trainer encodes the prepos flags
    (src/train_HAConvDR_topiocqa.py:36-39)."""
    prl = "goldPRL" if cfg.data.use_PRL else "noPRL"
    if cfg.data.is_PRF:
        return (
            f"bs{cfg.train.per_device_train_batch_size}-{cfg.data.mode}-{prl}-"
            f"{cfg.data.hard_neg_type}hard-{cfg.train.is_pseudo_prepos}prepos-"
            f"{cfg.data.is_PRF}PRF-{cfg.data.PRF_top}-retriever"
        )
    return (
        f"bs{cfg.train.per_device_train_batch_size}-{cfg.data.mode}-{prl}-"
        f"{cfg.train.is_prepos_neg}preposhard-{cfg.train.is_pseudo_prepos}prepos-"
        "best-retriever"
    )


def build_train_examples(cfg, tokenizer):
    """(examples, loss variant): the four-way dataset dispatch."""
    d = cfg.data
    if d.dataset == "topiocqa" and d.is_PRF:
        # the PRF trainer (src/train_HAConvDR_topiocqa_PRF.py:81,146) uses
        # the original Retrieval_topiocqa dataset (one extra example per
        # pseudo-prepos passage used as a positive) with the plain
        # cal_ranking_loss (pos matrix + 1 hard-neg column)
        from haconvdr_torch.data.topiocqa import build_topiocqa_train_examples_expanded

        return build_topiocqa_train_examples_expanded(
            d, tokenizer, d.train_file_path, is_pseudo_prepos=cfg.train.is_pseudo_prepos,
        ), "ranking"
    if d.dataset == "topiocqa":
        from haconvdr_torch.data.topiocqa import build_topiocqa_train_examples

        return build_topiocqa_train_examples(d, tokenizer, d.train_file_path), "prepos"
    if d.num_negs > 1:
        from haconvdr_torch.data.qrecc import build_qrecc_multineg_examples

        return build_qrecc_multineg_examples(
            d, tokenizer, d.train_file_path, num_negs=d.num_negs
        ), "ranking"
    from haconvdr_torch.data.qrecc import build_qrecc_examples

    return build_qrecc_examples(d, tokenizer, d.train_file_path), "ranking"


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    mesh = device_mesh(device)  # raises without the card before any read
    cfg = config_from_argv(argv)
    set_seed(cfg.train.seed)
    cfg.data.is_train = True

    tokenizer, params, model_cfg = load_checkpoint(
        cfg.model.model_type + "_Query", cfg.model.pretrained_encoder_path
    )
    model_cfg.remat = cfg.model.remat
    model_cfg.use_flash_attention = cfg.model.use_flash_attention
    cfg.model = model_cfg

    examples, loss_variant = build_train_examples(cfg, tokenizer)
    logger.info("train examples: %d", len(examples))

    out_dir = os.path.join(cfg.train.model_output_path, checkpoint_name(cfg))

    def save(model, step):
        save_hf_checkpoint(params_to_jax(model.state_dict()), cfg.model, out_dir)
        tokenizer.save_pretrained(out_dir)
        logger.info("step %d: checkpoint saved at %s", step, out_dir)

    trainer = Trainer(
        mesh, cfg.model, cfg.train,
        loss_variant=loss_variant,
        query_key=_QUERY_KEY[cfg.data.mode],
        save_fn=save,
    )
    # the frozen passage tower starts from the same checkpoint
    state, best = trainer.fit(params, params, examples)
    logger.info("training done; best loss %.5f", best)
    return state, best


if __name__ == "__main__":
    main()
