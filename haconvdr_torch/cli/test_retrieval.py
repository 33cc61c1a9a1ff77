"""CLI: retrieval evaluation (counterpart of haconvdr_tpu/cli/test_retrieval.py,
the reference's src/test_HAConvDR_topiocqa.py / test_HAConvDR_qrecc.py):
encode the test queries with a trained checkpoint, search the embedding
store, write the TREC run, print the metrics.

Usage: python -m haconvdr_torch.cli.test_retrieval --config cfg.toml
       [data.dataset=topiocqa search.test_type=convqp ...] [--device cuda|cpu]

The queries are encoded on the mesh of ``--device`` (every visible CUDA
card by default, refusing to start without one; ``cuda:N`` one card) and
the store is searched on its first card, as the JAX CLI streams it on one
device; ``--device cpu`` runs the plain twins.
"""

import logging

from haconvdr_torch.cli._args import device_mesh, pop_device
from haconvdr_torch.config import config_from_argv
from haconvdr_torch.models.hf_import import load_model
from haconvdr_torch.retrieval import (
    build_test_examples,
    gen_metric_score_and_save,
    get_test_query_embeddings,
)
from haconvdr_torch.utils.io import set_seed, setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    mesh = device_mesh(device)  # raises without the card before any read
    device = mesh.first
    cfg = config_from_argv(argv)
    set_seed(cfg.data.seed)
    cfg.data.is_train = False

    tokenizer, encoder = load_model(
        cfg.model.model_type + "_Query", cfg.model.pretrained_encoder_path, device
    )
    cfg.model = encoder.cfg
    examples = build_test_examples(cfg, tokenizer)
    logger.info("test examples: %d", len(examples))
    embs, ids = get_test_query_embeddings(cfg, encoder, examples=examples, mesh=mesh)
    res = gen_metric_score_and_save(cfg, embs, ids, device=device)
    logger.info("Test finish! %s", res)
    return res


if __name__ == "__main__":
    main()
