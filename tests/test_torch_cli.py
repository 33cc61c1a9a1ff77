"""The port's command-line entry points (haconvdr_torch/cli/*.py,
models/hf_import.load_model) against the JAX package's, on a tiny offline
HF checkpoint: a byte-level RoBERTa (or word-piece BERT) vocabulary
written to disk, ``ModelConfig.tiny`` weights from ``init_params_numpy``
saved by the port's ``save_hf_checkpoint`` (tests/test_cli_full.py's
recipe, with no download: ``utils/testing.write_tiny_hf_checkpoint``).

Pass conditions:
  * gen_tokenized_doc -> gen_doc_embeddings -> test_retrieval, run once by
    each package (the port with ``--device cpu``): the tokenized corpus is
    byte for byte the same; the TREC runs agree line for line in every
    column but the score, and the scores within 1e-5 (two float32 towers
    round differently, so the last digits of a score may differ); the
    metrics are equal, and MRR is 100.0;
  * test_prj, single pass and cross_validate over two folds: the same
    rel-label file, byte for byte;
  * train_retrieval (prepos and PRF): the JAX CLI's directory name, a
    checkpoint JAX's ``load_hf_checkpoint`` reads with the init's keys
    and shapes, weights equal to the port's own ``Trainer.fit`` on the
    same examples and seed, and moved from the init.  The JAX CLI's
    weights cannot be matched: its hidden dropout comes from the TPU's
    ``rbg`` bits, and ``config.json`` carries dropout 0.1;
  * load_model: embeddings within 1e-5 of the JAX ``load_model``'s
    encoder on the same token ids; an unknown type raises ValueError;
  * cli/serve.main: the ``[serve]`` keys reach Retriever.load and
    RetrievalServer, and the server answers as Retriever.retrieve.
"""

import dataclasses
import json
import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch

from haconvdr_tpu.models import hf_import as jhf
from haconvdr_torch.models import hf_import as thf
from haconvdr_torch.models.convert import params_to_jax
from haconvdr_torch.utils.testing import write_tiny_hf_checkpoint

transformers = pytest.importorskip("transformers")

N_PASSAGES = 12


def _passage(pid):
    return chr(96 + pid) * 3 + " " + chr(64 + pid) + str(pid)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_tiny_hf_checkpoint(tmp_path_factory.mktemp("ckpt"))


def _chain_args(ckpt, coll, out):
    tok = [
        f"model.pretrained_encoder_path={ckpt}",
        f"index.raw_collection_path={coll}",
        f"index.data_output_path={out / 'tokenized'}",
        "index.max_seq_length=16",
        "index.num_tokenize_workers=1",
    ]
    emb = [
        f"model.pretrained_encoder_path={ckpt}",
        f"index.tokenized_dir={out / 'tokenized'}",
        f"index.data_output_path={out / 'embeds'}",
        "index.per_device_eval_batch_size=1",
        "index.per_block_passage_num=8",
    ]
    return tok, emb


@pytest.fixture(scope="module")
def chain(ckpt, tmp_path_factory):
    """Tokenized corpus and embedding store, written once by each package."""
    from haconvdr_tpu.cli.gen_doc_embeddings import main as jax_embed
    from haconvdr_tpu.cli.gen_tokenized_doc import main as jax_tokenize
    from haconvdr_torch.cli.gen_doc_embeddings import main as torch_embed
    from haconvdr_torch.cli.gen_tokenized_doc import main as torch_tokenize

    root = tmp_path_factory.mktemp("chain")
    coll = root / "coll.tsv"
    with open(coll, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(1, N_PASSAGES + 1):
            f.write(f"{pid}\t{_passage(pid)}\tt [SEP] {pid}\n")
    for name, tokenize, embed, dev in (
        ("jax", jax_tokenize, jax_embed, []),
        ("torch", torch_tokenize, torch_embed, ["--device", "cpu"]),
    ):
        tok_args, emb_args = _chain_args(ckpt, coll, root / name)
        tokenize(tok_args)
        embed(emb_args + dev)
    return root


def test_tokenized_corpus_is_byte_identical(chain):
    names = sorted(os.listdir(chain / "jax" / "tokenized"))
    assert {"meta.json", "offset2pid.pickle"} <= set(names)
    assert sorted(os.listdir(chain / "torch" / "tokenized")) == names
    for name in names:
        got = (chain / "torch" / "tokenized" / name).read_bytes()
        assert got == (chain / "jax" / "tokenized" / name).read_bytes(), name


def _eval_files(tmp_path):
    test_file = tmp_path / "test.json"
    with open(test_file, "w") as f:
        for i, pid in enumerate((2, 9, 5)):
            f.write(json.dumps({
                "sample_id": f"CLI_1_{i + 1}", "cur_utt_text": _passage(pid),
                "last_response": "", "pos_docs": [_passage(pid)],
                "pos_docs_pids": [pid], "rel_label": [],
            }) + "\n")
    qrel = tmp_path / "qrel.trec"
    qrel.write_text("CLI_1_1 0 2 1\nCLI_1_2 0 9 1\nCLI_1_3 0 5 1\n")
    return test_file, qrel


def _split_run(path):
    rows = [line.split() for line in path.read_text().splitlines()]
    return [r[:5] + r[6:] for r in rows], np.array([float(r[5]) for r in rows])


def test_test_retrieval_matches_the_jax_cli(ckpt, chain, tmp_path):
    from haconvdr_tpu.cli.test_retrieval import main as jax_main
    from haconvdr_torch.cli.test_retrieval import main as torch_main

    test_file, qrel = _eval_files(tmp_path)
    res = {}
    for name, main, dev in (("jax", jax_main, []), ("torch", torch_main, ["--device=cpu"])):
        res[name] = main([
            f"model.pretrained_encoder_path={ckpt}",
            "data.dataset=topiocqa", f"data.test_file_path={test_file}",
            "data.use_PRL=false", "data.max_query_length=16", "data.max_doc_length=16",
            "data.max_concat_length=24", "search.test_type=convqp",
            f"search.passage_embeddings_dir_path={chain / name / 'embeds'}",
            f"search.passage_offset2pid_path={chain / name / 'tokenized' / 'offset2pid.pickle'}",
            f"search.qrel_output_path={tmp_path / name}", "search.output_trec_file=res.trec",
            f"search.trec_gold_qrel_file_path={qrel}", "search.top_k=5",
            "search.passage_chunk=8", "search.query_chunk=4",
            "search.per_device_test_batch_size=1",
        ] + dev)
    assert res["torch"] == res["jax"]
    assert res["torch"]["MRR"] == 100.0
    lines, scores = _split_run(tmp_path / "torch" / "res.trec")
    ref_lines, ref_scores = _split_run(tmp_path / "jax" / "res.trec")
    assert lines == ref_lines and len(lines) == 15 and lines[0][-1] == "ance"
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-5)


def _probe(pid_conv, turn, k, query, pair, gold):
    return {"id": f"{pid_conv}-{turn}-{k}", "conv_id": pid_conv, "turn_id": turn,
            "query": query, "query_pair": pair, "pos_docs_id": [gold], "last_response": ""}


def _probe_files(tmp_path, folds):
    """Per fold: one conversation, turn 2 with a base probe and three
    expansions (the gold text, another passage's, noise), turn 3 with a
    base probe that is the gold text itself; and their qrels."""
    paths, qrels = [], []
    for fold in range(folds):
        conv = 5 + fold
        g2, g3 = 3 + fold, 7 + fold
        recs = [
            _probe(conv, 2, 0, "zz" + str(fold), "", g2),
            _probe(conv, 2, 1, "zz" + str(fold), _passage(g2), g2),
            _probe(conv, 2, 2, "zz" + str(fold), _passage(11), g2),
            _probe(conv, 2, 3, "zz" + str(fold), "unrelated stuff", g2),
            _probe(conv, 3, 0, _passage(g3), "", g3),
            _probe(conv, 3, 1, _passage(g3), "unrelated stuff", g3),
        ]
        path = tmp_path / (f"probes.json.{fold}" if folds > 1 else "probes.json")
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        paths.append(path)
        qrels += [f"{r['id']} Q0 {r['pos_docs_id'][0]} 1\n" for r in recs]
    (tmp_path / "probe_qrel.trec").write_text("".join(qrels))
    return tmp_path / "probes.json", tmp_path / "probe_qrel.trec"


@pytest.mark.parametrize("folds", [1, 2], ids=["single", "cross_validate"])
def test_test_prj_matches_the_jax_cli(ckpt, chain, tmp_path, folds):
    from haconvdr_tpu.cli.test_prj import main as jax_main
    from haconvdr_torch.cli.test_prj import main as torch_main

    probes, probe_qrel = _probe_files(tmp_path, folds)
    model = ckpt
    extra = []
    if folds > 1:  # per-fold models fold_i/epoch-0, the second with its own weights
        model = str(tmp_path / "folds")
        shutil.copytree(ckpt, f"{model}/fold_0/epoch-0")
        write_tiny_hf_checkpoint(tmp_path / "folds" / "fold_1" / "epoch-0", seed=1)
        ori = tmp_path / "ori_qrel.json"
        ori.write_text(json.dumps({"sample_id": "QReCC-Test_5_1"}) + "\n")
        extra = ["cross_validate=true", f"num_folds={folds}", "test_epoch=0",
                 f"ori_qrel_file={ori}"]
    for name, main, dev in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        main([
            f"model.pretrained_encoder_path={model}", f"data.test_file_path={probes}",
            "data.max_query_length=16", "data.max_doc_length=16",
            "data.max_concat_length=48",
            f"search.passage_embeddings_dir_path={chain / name / 'embeds'}",
            f"search.passage_offset2pid_path={chain / name / 'tokenized' / 'offset2pid.pickle'}",
            f"search.trec_gold_qrel_file_path={probe_qrel}", "search.top_k=5",
            "search.passage_chunk=8", "search.query_chunk=4",
            "search.per_device_test_batch_size=1", f"prj_output={tmp_path / (name + '_rel.json')}",
        ] + extra + dev)
    got = (tmp_path / "torch_rel.json").read_bytes()
    assert got == (tmp_path / "jax_rel.json").read_bytes()
    labels = {json.loads(line)["id"]: json.loads(line)["rel_label"] for line in got.splitlines()}
    assert labels["5-3"] == [0]  # the base probe is the gold text: nothing beats it
    assert len(labels["5-2"]) == 3
    assert labels["5-1"] == []
    if folds > 1:  # the second fold's conversation; the qrel filter drops its turn 1
        assert len(labels["6-2"]) == 3 and labels["6-3"] == [0] and "6-1" not in labels


def _train_file(tmp_path, n, pseudo):
    import random

    r = random.Random(0)
    with open(tmp_path / "train.json", "w") as f:
        for i in range(n):
            words = " ".join(chr(97 + r.randrange(26)) for _ in range(4))
            f.write(json.dumps({
                "sample_id": f"T_1_{i + 1}", "cur_utt_text": words, "last_response": "",
                "pos_docs": [words + " gold"], "pos_docs_pids": [i], "rel_label": [],
                "bm25_hard_neg_docs": ["some negative text"],
                "pseudo_prepos_docs": [words + " pseudo"] if pseudo else [],
                "prepos_neg_docs": [],
            }) + "\n")
    return tmp_path / "train.json"


@pytest.mark.parametrize("prf", [False, True], ids=["prepos", "prf"])
def test_train_retrieval_writes_the_jax_checkpoint(ckpt, tmp_path, prf):
    from haconvdr_tpu.cli.train_retrieval import checkpoint_name as jax_name
    from haconvdr_tpu.config import config_from_argv as jax_config
    from haconvdr_torch.cli.train_retrieval import build_train_examples
    from haconvdr_torch.cli.train_retrieval import main as torch_main
    from haconvdr_torch.config import config_from_argv
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.train.trainer import Trainer

    train_file = _train_file(tmp_path, 8, pseudo=prf)
    args = [
        f"model.pretrained_encoder_path={ckpt}", "model.remat=false",
        "data.dataset=topiocqa", f"data.train_file_path={train_file}",
        "data.mode=convqp", "data.use_PRL=true",
        "data.max_query_length=12", "data.max_doc_length=12",
        "data.max_response_length=12", "data.max_concat_length=24",
        "train.num_train_epochs=1", "train.per_device_train_batch_size=1",
        "train.accumulation_steps=1", "train.print_steps=0",
        f"train.is_pseudo_prepos={'true' if prf else 'false'}", "train.is_prepos_neg=false",
        f"train.model_output_path={tmp_path / 'out'}",
    ]
    if prf:
        args += ["data.is_PRF=true", "data.PRF_top=1", "data.hard_neg_type=bm25"]
    torch_main(args + ["--device", "cpu"])
    ref_cfg = jax_config(args)
    ref_cfg.data.is_train = True
    assert os.listdir(tmp_path / "out") == [jax_name(ref_cfg)]
    saved = tmp_path / "out" / jax_name(ref_cfg)
    assert {"pytorch_model.bin", "config.json", "vocab.json", "merges.txt"} <= set(os.listdir(saved))

    got, got_cfg = jhf.load_hf_checkpoint(str(saved))
    init, init_cfg = jhf.load_hf_checkpoint(ckpt)
    assert dataclasses.asdict(got_cfg) | {"pretrained_encoder_path": ""} == (
        dataclasses.asdict(init_cfg) | {"pretrained_encoder_path": ""})
    sd, init_sd = jhf.state_dict_from_params(got, got_cfg), jhf.state_dict_from_params(init, init_cfg)
    assert sd.keys() == init_sd.keys()
    assert all(sd[k].shape == init_sd[k].shape for k in sd)
    assert max(float(np.abs(sd[k] - init_sd[k]).max()) for k in sd) > 0

    # the port's own Trainer.fit on the same examples, checkpoint and seed
    cfg = config_from_argv(args)
    cfg.data.is_train = True
    params, model_cfg = thf.load_hf_checkpoint(ckpt)
    model_cfg.remat = False
    cfg.model = model_cfg
    examples, variant = build_train_examples(cfg, thf.load_tokenizer("ANCE", ckpt))
    assert (len(examples), variant) == ((16, "ranking") if prf else (8, "prepos"))
    best = {}
    Trainer(make_mesh(devices=["cpu"]), model_cfg, cfg.train, loss_variant=variant,
            query_key="conv_qp",
            save_fn=lambda m, step: best.update(sd=params_to_jax(m.state_dict()))).fit(
        params, params, examples)
    want = jhf.state_dict_from_params(best["sd"], model_cfg)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)


def _token_ids(rng, n_vocab, B=3, L=20, lengths=(20, 7, 2)):
    ids = rng.randint(5, n_vocab, size=(B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
        ids[b, n:] = 1
    return ids, mask


@pytest.mark.parametrize("model_type", ["ANCE_Query", "BERT_Passage"])
def test_load_model_matches_jax(tmp_path, rng, model_type):
    path = write_tiny_hf_checkpoint(tmp_path / "ckpt", model_type.split("_")[0], seed=3)
    tok, enc = thf.load_model(model_type, path, device="cpu")
    ref_tok, ref_enc = jhf.load_model(model_type, path)
    assert type(tok) is type(ref_tok)
    assert tok.encode("the cat") == ref_tok.encode("the cat")
    assert next(enc.parameters()).device.type == "cpu"
    # config.json records no embedding_dim: the port reads it off the head
    # (16 here), JAX keeps ModelConfig's default
    assert enc.cfg.embedding_dim == 16
    assert dataclasses.asdict(enc.cfg) == dataclasses.asdict(ref_enc.cfg) | {"embedding_dim": 16}
    ids, mask = _token_ids(rng, enc.cfg.vocab_size)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref_enc(ids, mask), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown model type"):
        thf.load_model("T5_Query", path, device="cpu")
    with pytest.raises(ValueError, match="unknown model type"):
        jhf.load_model("T5_Query", path)


def test_serve_cli_passes_the_serve_section(ckpt, chain, tmp_path, monkeypatch):
    from haconvdr_torch.cli import serve as serve_cli
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.serve_http import RetrievalServer

    seen = {}
    real_load = Retriever.load.__func__

    def spy_load(cls, *a, **kw):
        seen["load"] = (a, kw)
        seen["retriever"] = real_load(cls, *a, **kw)
        return seen["retriever"]

    def fake_run(server):  # one request through the real server, then close
        server.start()
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/retrieve",
            data=json.dumps({"question": _passage(4), "k": 3}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            seen["answer"] = json.loads(r.read())
        server.close()

    monkeypatch.setattr(Retriever, "load", classmethod(spy_load))
    monkeypatch.setattr(RetrievalServer, "run", fake_run)
    o2p = chain / "torch" / "tokenized" / "offset2pid.pickle"
    args = [
        f"serve.checkpoint_path={ckpt}", f"serve.embeddings_dir={chain / 'torch' / 'embeds'}",
        f"serve.offset2pid_path={o2p}", "serve.port=0", "serve.max_batch=4",
        "serve.max_wait_ms=3.5", "serve.queue_depth=7", "serve.request_timeout_s=9",
        "serve.store_dtype=bfloat16", "serve.resident=false", "serve.ivf_nlist=16",
        "data.max_query_length=16", "data.max_concat_length=24", "search.top_k=5",
    ]
    server = serve_cli.main(args + ["--device", "cpu"])
    (ckpt_arg, emb_arg), kw = seen["load"]
    assert (ckpt_arg, emb_arg) == (ckpt, str(chain / "torch" / "embeds"))
    assert kw["store_dtype"] == "bfloat16" and kw["resident"] is False
    assert kw["ivf"] is False and kw["ivf_nlist"] == 16 and kw["ivf_nprobe"] is None
    assert kw["mesh"].slots == [torch.device("cpu")] and kw["encoder_int8"] is False
    assert kw["data_cfg"].is_train is False and kw["search_cfg"].top_k == 5
    assert list(kw["offset2pid"]) == list(range(1, N_PASSAGES + 1))
    assert server.batcher.max_batch == 4 and server.batcher.max_wait_ms == 3.5
    assert server.batcher.stats()["queue_depth"] == 7 and server.request_timeout_s == 9
    want = seen["retriever"].retrieve(_passage(4), k=3)
    assert [h["pid"] for h in seen["answer"]["hits"]] == [p for p, _ in want]
    assert want[0][0] == 4
    # serve.ivf=true: the IVF retriever (probing every cluster) answers as
    # JAX's Retriever.load with the same serve section
    from haconvdr_tpu.serve import Retriever as JaxRetriever

    serve_cli.main(args + ["serve.ivf=true", "serve.ivf_nprobe=1000", "--device", "cpu"])
    (ckpt_arg, emb_arg), kw = seen["load"]
    assert kw["ivf"] is True and kw["ivf_nprobe"] == 1000 and seen["retriever"].ivf_index is not None
    jr = JaxRetriever.load(ckpt_arg, emb_arg, **{k: v for k, v in kw.items() if k != "mesh"})
    want = jr.retrieve(_passage(4), k=3)
    got = [(h["pid"], h["score"]) for h in seen["answer"]["hits"]]
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], rtol=1e-5, atol=1e-5)
