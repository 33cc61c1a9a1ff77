"""CLI: PRJ labeling pass (counterpart of haconvdr_tpu/cli/test_prj.py, the
reference's src/test_PRJ_topiocqa.py / test_PRJ_qrecc.py): dense-retrieve
the probe queries, apply the MRR-difference judge, write the rel-label
JSONL.

Usage: python -m haconvdr_torch.cli.test_prj --config cfg.toml
       data.test_file_path=<probe_file> search.trec_gold_qrel_file_path=<probe qrels>
       [prj_output=<rel label output>] [ori_qrel_file=<qrecc qrel filter>]
       [cross_validate=true num_folds=5 test_epoch=E] [--device cuda|cpu]

``cross_validate=true`` runs the 5-fold pass: fold i encodes the probe
file ``<test_file_path>.i`` with the model ``<pretrained_encoder_path>/
fold_i/epoch-E``, and the folds' embeddings are joined before one search
(src/test_PRJ_topiocqa.py:501-523).  Towers and search run on
``--device``: the CUDA card by default, the plain twins with ``--device
cpu``.
"""

import logging

import numpy as np

from haconvdr_torch.cli._args import pop_device
from haconvdr_torch.config import config_from_argv
from haconvdr_torch.device import resolve_device
from haconvdr_torch.data.prj import build_prj_probe_examples
from haconvdr_torch.models.hf_import import load_model
from haconvdr_torch.retrieval import (
    get_test_query_embeddings,
    run_prj_labeling,
    write_rel_labels,
)
from haconvdr_torch.utils.io import read_jsonl_list, set_seed, setup_logging

logger = logging.getLogger(__name__)

_EXTRA_KEYS = ("prj_output", "ori_qrel_file", "cross_validate", "num_folds", "test_epoch")


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    device = resolve_device(device)  # raises without the card before any read
    extra = {}
    rest = []
    for a in argv:
        if any(a.startswith(p + "=") for p in _EXTRA_KEYS):
            k, _, v = a.partition("=")
            extra[k] = v
        else:
            rest.append(a)
    cfg = config_from_argv(rest)
    set_seed(cfg.data.seed)

    qrel_ids = None
    if "ori_qrel_file" in extra:
        qrel_ids = set()
        for rec in read_jsonl_list(extra["ori_qrel_file"]):
            conv, turn = rec["sample_id"].split("_")[-2:]
            qrel_ids.add(f"{conv}-{turn}")
    out = extra.get("prj_output", "rel_label.json")

    if extra.get("cross_validate", "").lower() in ("1", "true", "yes"):
        num_folds = int(extra.get("num_folds", 5))
        epoch = extra.get("test_epoch", "0")
        base_file = cfg.data.test_file_path
        base_model = cfg.model.pretrained_encoder_path
        probe_records, all_embs, all_ids = [], [], []
        tokenizer = None
        for fold in range(num_folds):
            tokenizer, encoder = load_model(
                cfg.model.model_type + "_Query", f"{base_model}/fold_{fold}/epoch-{epoch}",
                device,
            )
            cfg.model = encoder.cfg
            fold_file = f"{base_file}.{fold}"
            probe_records.extend(read_jsonl_list(fold_file))
            examples = build_prj_probe_examples(cfg.data, tokenizer, fold_file)
            embs, ids = get_test_query_embeddings(
                cfg, encoder, examples=examples, query_key="pair_query"
            )
            all_embs.append(embs)
            all_ids.extend(ids)
            del encoder
        rel = run_prj_labeling(
            cfg, None, probe_records, cfg.search.trec_gold_qrel_file_path,
            tokenizer, qrel_ids=qrel_ids,
            query_embs=np.concatenate(all_embs, axis=0), query_ids=all_ids,
            device=device,
        )
    else:
        tokenizer, encoder = load_model(
            cfg.model.model_type + "_Query", cfg.model.pretrained_encoder_path, device
        )
        cfg.model = encoder.cfg
        rel = run_prj_labeling(
            cfg, encoder, read_jsonl_list(cfg.data.test_file_path),
            cfg.search.trec_gold_qrel_file_path, tokenizer, qrel_ids=qrel_ids,
        )
    write_rel_labels(rel, out)
    logger.info("rel labels written to %s", out)
    return rel


if __name__ == "__main__":
    main()
