"""CLI: tokenize the passage collection (counterpart of
haconvdr_tpu/cli/gen_tokenized_doc.py, the reference's
gen_tokenized_doc.py).

Usage: python -m haconvdr_torch.cli.gen_tokenized_doc --config cfg.toml
       [index.raw_collection_path=... index.data_output_path=...] [title=true]

``title=true`` joins each passage's title before its text (tsv title
mode).  Tokenization runs on the host, in ``index.num_tokenize_workers``
processes; it takes no ``--device``.  The tokenizer is the one saved
beside ``model.pretrained_encoder_path`` (``hf_import.load_tokenizer``).
"""

import functools
import logging
import sys

from haconvdr_torch.config import config_from_argv
from haconvdr_torch.index.build import tokenize_collection
from haconvdr_torch.models.hf_import import load_tokenizer
from haconvdr_torch.utils.io import setup_logging


def main(argv=None):
    setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    title = False
    rest = []
    for a in argv:
        if a.startswith("title="):  # join title before text (tsv title mode)
            title = a.split("=", 1)[1].lower() in ("1", "true", "yes")
        else:
            rest.append(a)
    cfg = config_from_argv(rest)
    tokenizer_factory = functools.partial(
        load_tokenizer, cfg.model.model_type, cfg.model.pretrained_encoder_path
    )
    tokenizer = None
    if cfg.index.num_tokenize_workers <= 1:
        tokenizer = tokenizer_factory()
    corpus = tokenize_collection(
        cfg.index, tokenizer=tokenizer, tokenizer_factory=tokenizer_factory,
        title=title,
    )
    logging.getLogger(__name__).info("tokenized corpus: %d passages", len(corpus))
    return corpus


if __name__ == "__main__":
    main()
