"""Two processes of the PyTorch port under ``torch.distributed`` (the
``gloo`` backend on localhost, barriers only), modelled on
tests/test_multiprocess.py and tests/mp_worker.py:

* ``ivf``: a global 2-shard IVF index, one shard a process (each rank's
  mesh holds one CPU slot; the global shards are the ranks' slots in rank
  order).  ``save_ivf_sharded`` writes each rank's own shard files, all
  barrier, rank 0 writes the sidecars and the meta, all barrier;
  ``load_ivf_sharded`` reads each rank's own shard back.  Each rank's
  arrays must round-trip exactly, and the meta count every shard.  The
  JAX package then loads the directory onto two devices here.
* ``encode``: rank 0 tokenizes a corpus into a shared directory, both
  ranks encode their rank-mod stride into disjoint block ranges of one
  shared store (``encode_corpus(stride=2, offset=rank,
  start_block_id=2 * rank)``), and rank 0 stitches and checks it against a
  single-pass encode, offset for offset, bit for bit.
* ``retriever``: in each rank of the initialized group,
  ``Retriever(ivf=True)`` on a mesh of two CPU slots builds, saves and
  reloads the index of its own mesh: a mesh's shards are its own slots
  unless a caller asks for the ranks' global shards (``distributed``).

The worker is this file run as a script; it imports no ``jax``, asserts
internally and prints ``OK`` last.  Each child has a 120 s timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NPROC = 2
_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ground_truth():
    """The mp_worker.py index, the same in every process."""
    rs = np.random.RandomState(0)
    nlist, cap, D, R = 8, 4, 16, 6
    buckets = rs.randn(nlist, cap, D).astype(np.float32)
    bucket_ids = rs.permutation(nlist * cap).astype(np.int32).reshape(nlist, cap)
    bucket_ids[0, 2:] = -1  # pad slots
    tail = rs.randn(R, D).astype(np.float32)
    tail_ids = (1000 + np.arange(R)).astype(np.int32)
    centroids = rs.randn(nlist, D).astype(np.float32)
    return dict(centroids=centroids, buckets=buckets, bucket_ids=bucket_ids, tail=tail,
                tail_ids=tail_ids)


def _run_workers(mode: str, tmpdir: str) -> None:
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank), str(_NPROC),
             str(port), tmpdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(_NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a worker timed out:\n" + "\n---\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker rank={rank} exited {p.returncode}:\n{out}"
        assert f"rank={rank}: OK" in out, out


def test_mp_ivf_save_load_roundtrip(tmp_path):
    """Each rank writes and reads only its own shard; the directory then
    loads in the JAX package onto two devices as the global index."""
    import jax

    from haconvdr_tpu.parallel.sharded_ivf import load_ivf_sharded

    _run_workers("ivf", str(tmp_path))
    out = str(tmp_path / "ivf_mp")
    assert sorted(os.listdir(out)) == sorted(
        [f"{n}_{s:03d}.npy" for n in ("buckets", "bucket_ids", "tail", "tail_ids")
         for s in range(2)] + ["centroids.npy", "ivf_sharded_meta.json"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("d",))
    back = load_ivf_sharded(mesh, out)
    for name, ref in _ground_truth().items():
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), ref, err_msg=name)


def test_mp_corpus_encode_stride_stitch(tmp_path):
    """Two ranks encode their strides into one store; rank 0 stitches and
    compares with a single-pass encode."""
    _run_workers("encode", str(tmp_path))


def test_mp_retriever_ivf_stays_per_process(tmp_path):
    """Retriever(ivf=True) inside a group of two ranks: each rank's index
    holds its own mesh's two shards, reloads from its ivf_dir, and at full
    probe answers as the flat index on the same mesh."""
    _run_workers("retriever", str(tmp_path))


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _init(rank: int, world: int, port: str):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    assert dist.get_rank() == rank and dist.get_world_size() == world
    return dist


def run_ivf(rank: int, world: int, port: str, tmpdir: str) -> None:
    import torch

    from haconvdr_torch.index.ivf import IVFIndex
    from haconvdr_torch.parallel import sharded_ivf as tsharded
    from haconvdr_torch.parallel.mesh import make_mesh

    dist = _init(rank, world, port)
    truth = _ground_truth()
    whole = IVFIndex(nprobe=4, **{k: torch.from_numpy(v) for k, v in truth.items()})
    mesh = make_mesh(devices=["cpu"])  # this rank's slot; 2 shards in all
    index = tsharded.shard_ivf(mesh, whole, distributed=True)
    assert index.n_shards == world and index.first_shard == rank and len(index.shards) == 1
    out = os.path.join(tmpdir, "ivf_mp")
    tsharded.save_ivf_sharded(index, out)  # barriers inside: the directory is complete

    opened = []
    real_open = tsharded.open_npy
    tsharded.open_npy = lambda path: opened.append(os.path.basename(path)) or real_open(path)
    back, meta = tsharded.load_ivf_sharded(out, with_meta=True, mesh=mesh, distributed=True)
    tsharded.open_npy = real_open
    assert meta["n_shards"] == world and meta["nlist"] == 8 and meta["tail_rows"] == 6
    assert meta["corpus_rows"] == int((truth["bucket_ids"] >= 0).sum()) + 6, meta
    assert {f for f in opened if not f.startswith("tail_ids")} == {
        f"{n}_{rank:03d}.npy" for n in ("buckets", "bucket_ids", "tail")}, opened
    (sh,) = back.shards
    per, rows = 8 // world, 6 // world
    for name, ref in (("buckets", truth["buckets"][rank * per : (rank + 1) * per]),
                      ("bucket_ids", truth["bucket_ids"][rank * per : (rank + 1) * per]),
                      ("tail", truth["tail"][rank * rows : (rank + 1) * rows]),
                      ("tail_ids", truth["tail_ids"][rank * rows : (rank + 1) * rows])):
        np.testing.assert_array_equal(getattr(sh, name).numpy(), ref, err_msg=name)
    np.testing.assert_array_equal(sh.centroids.numpy(), truth["centroids"])
    dist.barrier()
    dist.destroy_process_group()


def run_encode(rank: int, world: int, port: str, tmpdir: str) -> None:
    import torch

    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.index.build import encode_corpus
    from haconvdr_torch.index.store import (
        EmbeddingBlockStore,
        TokenizedCorpus,
        TokenizedCorpusWriter,
    )
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder

    dist = _init(rank, world, port)
    cfg = ModelConfig.tiny()
    enc = AnceEncoder.from_jax_params(init_params_numpy(cfg, seed=2), cfg, "cpu")
    L, n = 10, 53
    tok_dir = os.path.join(tmpdir, "tok")
    if rank == 0:
        rs = np.random.RandomState(7)
        w = TokenizedCorpusWriter(tok_dir, L)
        for i in range(n):
            w.add(1000 + i, rs.randint(4, cfg.vocab_size, size=rs.randint(3, L + 1)).tolist())
        w.finalize()
    dist.barrier()
    corpus = TokenizedCorpus(tok_dir)
    shared = os.path.join(tmpdir, "shared")
    # ceil(53 / 2) <= 27 rows a stride: two blocks of 16 each
    with torch.inference_mode():
        encode_corpus(corpus, enc, shared, batch_size=8, per_block_passage_num=16,
                      stride=world, offset=rank, start_block_id=2 * rank)
    dist.barrier()
    if rank == 0:
        single = os.path.join(tmpdir, "single")
        encode_corpus(corpus, enc, single, batch_size=8, per_block_passage_num=16)

        def id_map(store_dir):
            store, got = EmbeddingBlockStore(store_dir), {}
            for b in range(store.num_blocks()):
                emb, ids = store.read_block(b)
                for row, off in zip(np.asarray(emb), np.asarray(ids)):
                    assert int(off) not in got
                    got[int(off)] = row
            return got

        ref, got = id_map(single), id_map(shared)
        assert set(ref) == set(got) == set(range(n))
        for off in ref:
            np.testing.assert_array_equal(ref[off], got[off])
    dist.barrier()
    dist.destroy_process_group()


def run_retriever(rank: int, world: int, port: str, tmpdir: str) -> None:
    from haconvdr_torch.config import DataConfig, ModelConfig, SearchConfig
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.parallel.sharded_ivf import ShardedIVFIndex
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    dist = _init(rank, world, port)
    cfg = ModelConfig.tiny(vocab_size=512)
    x = np.random.RandomState(3).randn(400, cfg.embedding_dim).astype(np.float32)
    store = EmbeddingBlockStore(os.path.join(tmpdir, f"emb_{rank}"))
    store.write_block(0, x, np.arange(400, dtype=np.int64))
    args = (HashTokenizer(cfg.vocab_size), init_params_numpy(cfg, 11), cfg, store)
    mesh = make_mesh(devices=["cpu"] * 2)
    kw = dict(mesh=mesh, search_cfg=SearchConfig(top_k=8),
              data_cfg=DataConfig(is_train=False, use_PRL=False, max_query_length=12,
                                  max_doc_length=16, max_response_length=8,
                                  max_concat_length=32))
    ivf_kw = dict(ivf=True, ivf_nlist=16, ivf_nprobe=16, ivf_dir=os.path.join(tmpdir, f"ivf_{rank}"))
    built = Retriever(*args, **ivf_kw, **kw)
    again = Retriever(*args, **ivf_kw, **kw)  # reloaded from ivf_dir
    flat = Retriever(*args, **kw)
    for r in (built, again):
        idx = r.ivf_index
        assert isinstance(idx, ShardedIVFIndex) and idx.n_shards == 2 == len(idx.shards)
        assert idx.nlist == 16 == idx.nprobe
    for question, history in (("what is the capital of france", [("who wrote hamlet", "x")]),
                              ("tell me about rivers", [])):
        got = built.retrieve(question, history)
        assert again.retrieve(question, history) == got
        ref = flat.retrieve(question, history)
        assert [p for p, _ in got] == [p for p, _ in ref], (got, ref)
        np.testing.assert_allclose([v for _, v in got], [v for _, v in ref], rtol=1e-5)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, world, port, tmpdir = sys.argv[1:6]
    sys.path.insert(0, _REPO)
    {"ivf": run_ivf, "encode": run_encode, "retriever": run_retriever}[mode](int(rank), int(world), port, tmpdir)
    print(f"torch mp worker {mode} rank={rank}: OK", flush=True)
