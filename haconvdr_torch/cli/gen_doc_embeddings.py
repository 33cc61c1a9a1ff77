"""CLI: encode the tokenized collection into embedding blocks (counterpart
of haconvdr_tpu/cli/gen_doc_embeddings.py, the reference's
gen_doc_embeddings.py), data-parallel over the mesh of ``--device``.

Usage: python -m haconvdr_torch.cli.gen_doc_embeddings --config cfg.toml
       [key=value ...] [shard_stride=N shard_offset=i start_block_id=B]
       [--device cuda|cpu]

``shard_stride``/``shard_offset`` shard the corpus rank-mod and
``start_block_id`` numbers this run's blocks, for multi-process and
resumed runs.  ``index.compute_int8`` encodes with the int8 tower.  The
checkpoint's config gives the tower float32 (``config_from_hf``), so an
int8 tower here has a float32 carry and runs the unfused int8 dense, as the
JAX CLI's does.  It encodes on every visible CUDA card (``--device``,
default ``cuda``: each batch cut over the cards, one replica of the tower
a card) and refuses to start without one; ``--device cuda:N`` uses one
card, ``--device cpu`` runs the plain twins on the CPU.
"""

import logging

from haconvdr_torch.cli._args import device_mesh, pop_device
from haconvdr_torch.config import config_from_argv
from haconvdr_torch.index.build import encode_corpus
from haconvdr_torch.index.store import TokenizedCorpus
from haconvdr_torch.models import build_tower
from haconvdr_torch.models.hf_import import load_hf_checkpoint
from haconvdr_torch.utils.io import setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    extra = {"shard_stride": "1", "shard_offset": "0", "start_block_id": "0"}
    rest = []
    for a in argv:
        k, _, v = a.partition("=")
        if k in extra:
            extra[k] = v
        else:
            rest.append(a)
    mesh = device_mesh(device)  # raises before any work without the card
    dev = mesh.first
    cfg = config_from_argv(rest)
    corpus = TokenizedCorpus(cfg.index.tokenized_dir or cfg.index.data_output_path)
    params, model_cfg = load_hf_checkpoint(
        cfg.model.pretrained_encoder_path, cfg.model.model_type
    )
    encoder = build_tower(params, model_cfg, dev, int8=cfg.index.compute_int8)
    logger.info(
        "encoding %d passages on %s (%s tower)", len(corpus), mesh,
        "int8" if encoder.int8 else model_cfg.dtype,
    )
    store = encode_corpus(
        corpus,
        encoder,
        cfg.index.data_output_path,
        batch_size=cfg.index.per_device_eval_batch_size * mesh.size,
        per_block_passage_num=cfg.index.per_block_passage_num,
        store_dtype=cfg.index.store_dtype,
        stride=int(extra["shard_stride"]),
        offset=int(extra["shard_offset"]),
        start_block_id=int(extra["start_block_id"]),
        mesh=mesh,
    )
    logger.info("embedding blocks written: %d", store.num_blocks())
    return store


if __name__ == "__main__":
    main()
