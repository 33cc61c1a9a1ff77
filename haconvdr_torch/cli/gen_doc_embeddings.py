"""CLI: encode the tokenized collection into embedding blocks (counterpart
of haconvdr_tpu/cli/gen_doc_embeddings.py, the reference's
gen_doc_embeddings.py), on one device.

Usage: python -m haconvdr_torch.cli.gen_doc_embeddings --config cfg.toml
       [key=value ...] [shard_stride=N shard_offset=i start_block_id=B]
       [--device cuda|cpu]

``shard_stride``/``shard_offset`` shard the corpus rank-mod and
``start_block_id`` numbers this run's blocks, for multi-process and
resumed runs.  ``index.compute_int8`` encodes with the int8 tower.  The
checkpoint's config gives the tower float32 (``config_from_hf``), so an
int8 tower here has a float32 carry and runs the unfused int8 dense, as the
JAX CLI's does.  It encodes on the CUDA card (``--device``, default
``cuda``) and refuses to start without one; ``--device cpu`` runs the
plain twins on the CPU.
"""

import logging
import sys

from haconvdr_torch.config import config_from_argv
from haconvdr_torch.device import resolve_device
from haconvdr_torch.index.build import encode_corpus
from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
from haconvdr_torch.index.store import TokenizedCorpus
from haconvdr_torch.models.hf_import import load_hf_checkpoint
from haconvdr_torch.utils.io import setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = {"shard_stride": "1", "shard_offset": "0", "start_block_id": "0"}
    device = "cuda"
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        k, _, v = a.partition("=")
        if a == "--device":
            if i + 1 == len(argv):
                raise ValueError("--device needs a value (cuda or cpu)")
            device = argv[i + 1]
            i += 1
        elif k == "--device":
            device = v
        elif k in extra:
            extra[k] = v
        else:
            rest.append(a)
        i += 1
    dev = resolve_device(device)  # raises before any work without the card
    cfg = config_from_argv(rest)
    corpus = TokenizedCorpus(cfg.index.tokenized_dir or cfg.index.data_output_path)
    params, model_cfg = load_hf_checkpoint(
        cfg.model.pretrained_encoder_path, cfg.model.model_type
    )
    if cfg.index.compute_int8:
        params = quantize_encoder_params(params)
    encoder = AnceEncoder.from_jax_params(params, model_cfg, dev)
    logger.info(
        "encoding %d passages on %s (%s tower)", len(corpus), dev,
        "int8" if encoder.int8 else model_cfg.dtype,
    )
    store = encode_corpus(
        corpus,
        encoder,
        cfg.index.data_output_path,
        batch_size=cfg.index.per_device_eval_batch_size,
        per_block_passage_num=cfg.index.per_block_passage_num,
        store_dtype=cfg.index.store_dtype,
        stride=int(extra["shard_stride"]),
        offset=int(extra["shard_offset"]),
        start_block_id=int(extra["start_block_id"]),
    )
    logger.info("embedding blocks written: %d", store.num_blocks())
    return store


if __name__ == "__main__":
    main()
