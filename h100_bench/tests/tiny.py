"""A benchmark cell cut to a size the CPU runs in seconds: the same files,
found by the same names, with the widths and counts shrunk."""

from __future__ import annotations

import copy

from h100_bench.harness.cell import ROOT, load_cell

TINY_MODEL = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
              "intermediate_size": 256, "vocab_size": 1000, "max_position_embeddings": 80,
              "embedding_dim": 128, "max_concat_length": 64,
              # two layers of 128 need wider weights than the full tower for their
              # first token's embedding to depend on the request
              "init_std": 0.2}


def tiny_cell(name: str, root=ROOT):
    cell = load_cell(name, root)
    c = copy.deepcopy(cell.config)
    c.update(TINY_MODEL)
    c["index"].update(rows=5000, dim=128, top_k=10)
    c["check"] = {"sample": 12}
    t = copy.deepcopy(cell.traffic)
    if t["kind"] == "serve":
        t.update(max_batch=4)
        if "clients" in t:
            t["clients"] = 8
        else:
            t["rate"] = 40.0
        t["sessions"].update(words=300, pool=64, question_words=[2, 5], answer_words=[1, 4],
                             passage_words=[3, 10], turns=[1, min(t["sessions"]["turns"][1], 4)])
    else:
        t["corpus"].update(passages=256, max_seq_length=32, length=[8, 32], batch=16, block=64)
    cell.config, cell.traffic = c, t
    return cell
