"""Collection loading helpers shared by the preprocessing pipelines
(counterpart of haconvdr_tpu/preprocess/collections.py).

The TopiOCQA wiki collection is a TSV ``id\\ttext\\ttitle`` whose titles
embed ``' [SEP] '`` separators that get flattened to spaces, and whose
passage text is ``title + ' ' + text``
(preprocess/preprocess_topicoqa.py:33-40).  The QReCC collection is built
from the commoncrawl/wayback paragraph dumps into ``pid\\tcontents`` with a
dense pid space and a pid->raw-id map
(preprocess/preprocess_qrecc.py:18-60).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
from typing import Dict, Iterator, Tuple

logger = logging.getLogger(__name__)


def iter_topiocqa_collection(path: str) -> Iterator[Tuple[int, str]]:
    """Yield (pid, 'title text') records, skipping the header row."""
    csv.field_size_limit(sys.maxsize)
    with open(path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        for row in reader:
            if row[0] == "id":
                continue
            pid = int(row[0])
            title = " ".join(row[2].split(" [SEP] "))
            yield pid, " ".join([title, row[1]])


def load_topiocqa_collection(path: str) -> Dict[int, str]:
    return dict(iter_topiocqa_collection(path))


def iter_jsonl_collection(path: str) -> Iterator[Tuple[int, str]]:
    """Yield (pid, 'title[SEP]text') from a {id, title, text} JSONL dump
    (the reference's jsonl branch of load_collection, src/utils.py:84-90)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            yield int(obj["id"]), obj["title"] + "[SEP]" + obj["text"]


def iter_qrecc_collection(path: str) -> Iterator[Tuple[int, str]]:
    """Yield (pid, passage) from the flat qrecc tsv; malformed lines yield
    empty text (preprocess/preprocess_qrecc.py:203-212)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            try:
                pid = int(parts[0])
            except ValueError:
                continue
            yield pid, parts[1] if len(parts) > 1 else ""


def convert_collection_to_jsonl(wiki_file: str, output_file: str) -> None:
    """TSV collection -> {"contents", "id": "docN"} JSONL, the pyserini
    ingest format (bm25/convert_to_pyserini_file.py:15-27).  Kept for
    interop with external Lucene tooling; our own BM25 indexes the TSV
    directly (mine/bm25.py)."""
    csv.field_size_limit(sys.maxsize)
    with open(wiki_file, "r", encoding="utf-8") as fin, open(
        output_file, "w", encoding="utf-8"
    ) as fout:
        reader = csv.reader(fin, delimiter="\t")
        for i, row in enumerate(reader):
            if row[0] == "id":
                continue
            title = " ".join(row[2].split(" [SEP] "))
            obj = {"contents": " ".join([title, row[1]]), "id": f"doc{i}"}
            fout.write(json.dumps(obj, ensure_ascii=False) + "\n")


def gen_qrecc_passage_collection(
    input_passage_dir: str, output_file: str, pid2rawpid_path: str
) -> int:
    """Flatten the QReCC paragraph dumps (commoncrawl, wayback,
    wayback-backfill subdirs of jsonl files with {id, contents}) into a
    ``pid\\tcontents`` TSV + pid->rawpid pickle
    (preprocess/preprocess_qrecc.py:18-60).  Returns the passage count."""
    from haconvdr_torch.utils.io import pstore

    pid = 0
    pid2rawpid = []
    with open(output_file, "w", encoding="utf-8") as fw:
        for sub in ("commoncrawl", "wayback", "wayback-backfill"):
            dir_path = os.path.join(input_passage_dir, sub)
            if not os.path.isdir(dir_path):
                continue
            for filename in sorted(os.listdir(dir_path)):
                with open(os.path.join(dir_path, filename), "r", encoding="utf-8") as f:
                    for line in f:
                        obj = json.loads(line)
                        pid2rawpid.append(obj["id"])
                        fw.write(f"{pid}\t{obj['contents']}\n")
                        pid += 1
            logger.info("%s processed", dir_path)
    pstore(pid2rawpid, pid2rawpid_path)
    logger.info("QReCC collection -> %s (%d passages)", output_file, pid)
    return pid
