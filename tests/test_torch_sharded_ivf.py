"""The IVF tier on a mesh (haconvdr_torch/parallel/sharded_ivf.py:
shard_ivf, build_ivf_from_store, sharded_ivf_search, save/load_ivf_sharded;
Retriever(ivf=True, mesh=...)) against the JAX package on its 8-device
virtual CPU mesh, with the port's mesh of 8 CPU slots.

Tolerances, as tests/test_torch_ivf.py states them:
* builds, with the port's k-means init patched to JAX's rows: each
  shard's bucket ids and tail ids identical to JAX's shard, float bucket
  rows identical, centroids within rtol 1e-5; int8: the global scheme's
  codes and scale identical, residual codes within one at a .5 boundary;
* search: ids identical wherever adjacent scores differ by more than
  1e-5 |s|, scores within 1e-5 relative (two float32 sums in another
  order); across slot counts of one saved index, bit for bit;
* files: the per-shard arrays the port saves are JAX's bytes (a JAX-built
  index saved by both packages: every file).
"""

import json

import numpy as np
import pytest
import torch

from haconvdr_tpu.index import ivf as jivf
from haconvdr_tpu.parallel import sharded_ivf as jsharded
from haconvdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from haconvdr_torch.index import ivf as tivf
from haconvdr_torch.parallel import sharded_ivf as tsharded
from haconvdr_torch.parallel.mesh import make_mesh
from haconvdr_torch.parallel.sharded_ivf import ShardedIVFIndex
from test_torch_ivf import (
    QUANT,
    _by_id,
    _jax_init,
    _mixture,
    _write_store,
    assert_residual_codes_close,
    assert_search_equal,
)

K = 10


def cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture()
def shared_init(monkeypatch):
    monkeypatch.setattr(tivf, "init_rows", _jax_init)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.RandomState(31)
    x = _mixture(rng, 3000, 32, n_modes=24)
    q = _mixture(rng, 6, 32, n_modes=24)
    return x, q, _write_store(tmp_path_factory.mktemp("sivf") / "store", x)


BUILD = dict(nlist=32, nprobe=6, slack=1.3, seed=5, chunk_rows=512)


@pytest.fixture(scope="module")
def built(data):
    """``built(package, dtype)``: the 8-shard build of the shared store by
    JAX on its 8 devices or by the port on 8 slots (its own k-means init),
    made once a module."""
    store = data[2]
    cache = {}

    def get(package, dtype):
        if (package, dtype) not in cache:
            if package == "jax":
                cache[package, dtype] = jsharded.build_ivf_from_store(
                    jax_make_mesh(), store, dtype=dtype, **BUILD)
            else:
                cache[package, dtype] = tsharded.build_ivf_from_store(
                    cpu_mesh(), store, dtype=dtype, **BUILD)
        return cache[package, dtype]

    return get


def _jax_shard(ref, name, s, n=8):
    a = np.asarray(getattr(ref, name))
    per = a.shape[0] // n
    return a[s * per : (s + 1) * per]


def _np(t):
    return tivf.to_numpy(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8_global", "int8_residual"])
def test_build_on_8_slots_matches_jax(data, shared_init, dtype):
    """build_ivf_from_store on 8 slots against JAX's on 8 devices: shard s
    holds clusters [4 s, 4 s + 4) and the s-th round-robin slice of the
    spill, as JAX's shard s does, and the answers agree."""
    x, q, store = data
    kw = dict(nlist=32, nprobe=6, slack=1.1, seed=5, chunk_rows=512,
              dtype="int8" if dtype.startswith("int8") else dtype,
              by_residual=dtype == "int8_residual")
    ref = jsharded.build_ivf_from_store(jax_make_mesh(), store, **kw)
    ours = tsharded.build_ivf_from_store(cpu_mesh(), store, **kw)
    assert isinstance(ours, ShardedIVFIndex) and ours.n_shards == 8 and ours.nlist == 32
    np.testing.assert_allclose(_np(ours.centroids), np.asarray(ref.centroids), rtol=1e-5,
                               atol=1e-6)
    tail_rows = np.asarray(ref.tail).shape[0] // 8
    assert tail_rows % 8 == 0 and int((np.asarray(ref.tail_ids) >= 0).sum()) > 8
    for s, sh in enumerate(ours.shards):
        assert sh.buckets.shape == (4,) + np.asarray(ref.buckets).shape[1:]
        assert sh.tail.shape[0] == tail_rows
        np.testing.assert_array_equal(_np(sh.bucket_ids), _jax_shard(ref, "bucket_ids", s))
        np.testing.assert_array_equal(_np(sh.tail_ids), _jax_shard(ref, "tail_ids", s))
        if dtype != "int8_residual":
            np.testing.assert_array_equal(_np(sh.buckets), _jax_shard(ref, "buckets", s)
                                          .astype(_np(sh.buckets).dtype))
            np.testing.assert_array_equal(_np(sh.tail), _jax_shard(ref, "tail", s)
                                          .astype(_np(sh.tail).dtype))
    if dtype == "int8_global":
        np.testing.assert_array_equal(_np(ours.shards[3].scale), np.asarray(ref.scale))
    if dtype == "int8_residual":
        whole = tivf.IVFIndex(  # the shards' slices in shard order: JAX's global arrays
            centroids=ours.centroids, nprobe=6,
            **{n: torch.cat([getattr(sh, n) for sh in ours.shards]) for n in tsharded.SHARDED},
            **{n: getattr(ours.shards[0], n) for n in tivf.SIDECARS})
        ids = _np(whole.bucket_ids)
        rows = np.where((ids >= 0)[..., None], x[np.clip(ids, 0, None)], 0.0)
        ot, rt = _np(whole.tail_ids), np.asarray(ref.tail_ids)
        assert_residual_codes_close(
            whole, ref, rows,
            (_by_id(_np(whole.tail), ot), _by_id(np.asarray(ref.tail), rt),
             x[np.sort(ot[ot >= 0])]), dtype)
    rs, ri = jsharded.sharded_ivf_search(jax_make_mesh(), ref, q, k=K)
    s, i = tsharded.sharded_ivf_search(cpu_mesh(), ours, q, k=K)
    assert_search_equal(s, i, rs, ri, dtype)


@pytest.mark.parametrize("nprobe", [6, 32], ids=["partial", "full"])
@pytest.mark.parametrize("dtype", list(QUANT))
def test_sharded_search_matches_jax(data, dtype, nprobe):
    """One JAX-built index placed on 8 slots (shard_ivf) and on JAX's 8
    devices: sharded_ivf_search answers as JAX's, in each bucket dtype, and
    as the port's one-device search of the same index."""
    x, q, _ = data
    f32 = jivf.build_ivf(x, nlist=32, nprobe=6, slack=1.3, seed=5)
    make = QUANT[dtype]
    jidx = (jivf.build_ivf(x, nlist=32, nprobe=6, slack=1.3, seed=5, dtype="bfloat16")
            if make is None else make(f32))
    whole = tivf.ivf_index_from_jax(jidx, "cpu")
    ours = tsharded.shard_ivf(cpu_mesh(), whole)
    jmesh = jax_make_mesh()
    rs, ri = jsharded.sharded_ivf_search(jmesh, jsharded.shard_ivf(jmesh, jidx), q, k=K,
                                         nprobe=nprobe)
    s, i = tsharded.sharded_ivf_search(cpu_mesh(), ours, q, k=K, nprobe=nprobe)
    assert_search_equal(s, i, rs, ri, dtype)
    s1, i1 = tivf.ivf_search(whole, q, k=K, nprobe=nprobe)
    assert_search_equal(s, i, s1, i1, dtype + " one device")


def test_search_with_probes_on_few_shards(data):
    """nprobe 1: each query reads one shard's cluster, the other seven
    shards score their tail slices alone; k past one bucket fills from the
    tail, empty slots stay (-inf, -1)."""
    x, q, _ = data
    whole = tivf.ivf_index_from_jax(jivf.build_ivf(x, nlist=32, nprobe=1, slack=1.0, seed=2),
                                    "cpu")
    ours = tsharded.shard_ivf(cpu_mesh(), whole)
    cap = whole.buckets.shape[1]
    for k in (5, cap + 3):
        s, i = tsharded.sharded_ivf_search(cpu_mesh(), ours, q, k=k, nprobe=1)
        s1, i1 = tivf.ivf_search(whole, q, k=k, nprobe=1)
        assert_search_equal(s, i, s1, i1, f"k {k}")
        assert (i[np.isneginf(s)] == -1).all()
    with pytest.raises(ValueError, match="exceeds"):
        tsharded.sharded_ivf_search(cpu_mesh(), ours, q, k=cap + whole.tail.shape[0] + 64, nprobe=1)


def test_sharded_files_are_jax_bytes(data, built, tmp_path, shared_init):
    """A JAX-built 8-shard index saved by JAX and by the port (placed with
    shard_ivf): every file byte for byte and the same meta.  The port's own
    8-slot build (with JAX's init rows) writes JAX's per-shard arrays byte
    for byte too."""
    _, _, store = data
    for dtype in ("bfloat16", "int8"):
        jbuilt = built("jax", dtype)
        jdir, tdir = tmp_path / f"jax_{dtype}", tmp_path / f"port_{dtype}"
        jsharded.save_ivf_sharded(jbuilt, str(jdir))
        tsharded.save_ivf_sharded(
            tsharded.shard_ivf(cpu_mesh(), tivf.ivf_index_from_jax(jbuilt, "cpu")), str(tdir))
        names = sorted(p.name for p in jdir.iterdir())
        assert names == sorted(p.name for p in tdir.iterdir()) and "buckets_007.npy" in names
        for name in names:
            if name.endswith(".json"):
                assert json.loads((jdir / name).read_text()) == json.loads(
                    (tdir / name).read_text())
            else:
                assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
        if dtype == "bfloat16":  # the port's own build: the same sharded arrays
            own = tmp_path / "own"
            tsharded.save_ivf_sharded(
                tsharded.build_ivf_from_store(cpu_mesh(), store, dtype=dtype, **BUILD), str(own))
            for s in range(8):
                for name in tsharded.SHARDED:
                    f = f"{name}_{s:03d}.npy"
                    assert (own / f).read_bytes() == (jdir / f).read_bytes(), f
            meta = json.loads((own / "ivf_sharded_meta.json").read_text())
            assert meta == json.loads((jdir / "ivf_sharded_meta.json").read_text())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_each_package_loads_the_others_8_shard_dir(data, built, tmp_path, dtype):
    """The port loads JAX's 8-shard directory onto 8 slots and JAX loads the
    port's onto 8 devices; both answer as the index that was saved."""
    q = data[1]
    jmesh = jax_make_mesh()
    jbuilt = built("jax", dtype)
    jsharded.save_ivf_sharded(jbuilt, str(tmp_path / "jax"))
    ours, meta = tsharded.load_ivf_sharded(str(tmp_path / "jax"), with_meta=True,
                                           mesh=cpu_mesh())
    assert meta["n_shards"] == 8 and isinstance(ours, ShardedIVFIndex)
    for s, sh in enumerate(ours.shards):
        np.testing.assert_array_equal(_np(sh.bucket_ids), _jax_shard(jbuilt, "bucket_ids", s))
    rs, ri = jsharded.sharded_ivf_search(jmesh, jbuilt, q, k=K)
    assert_search_equal(*tsharded.sharded_ivf_search(cpu_mesh(), ours, q, k=K), rs, ri,
                      "port loads jax")
    tbuilt = built("port", dtype)
    tsharded.save_ivf_sharded(tbuilt, str(tmp_path / "port"))
    back = jsharded.load_ivf_sharded(jmesh, str(tmp_path / "port"))
    s, i = tsharded.sharded_ivf_search(cpu_mesh(), tbuilt, q, k=K)
    assert_search_equal(*jsharded.sharded_ivf_search(jmesh, back, q, k=K), s, i, "jax loads port")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_loads_onto_1_2_4_and_8_slots(data, built, tmp_path, dtype):
    """An 8-shard save re-split onto 1, 2, 4 and 8 slots: each slot count's
    arrays are JAX's load onto as many devices, and every load answers bit
    for bit as the index that was saved."""
    import jax

    q = data[1]
    index = built("port", dtype)
    out = str(tmp_path / "ivf")
    tsharded.save_ivf_sharded(index, out)
    s8, i8 = tsharded.sharded_ivf_search(cpu_mesh(), index, q, k=K)
    for n in (1, 2, 4, 8):
        got = tsharded.load_ivf_sharded(out, mesh=cpu_mesh(n))
        ref = jsharded.load_ivf_sharded(jax.sharding.Mesh(np.array(jax.devices()[:n]), ("d",)),
                                        out)
        shards = [got] if n == 1 else list(got.shards)
        for s, sh in enumerate(shards):
            for name in tsharded.SHARDED:
                np.testing.assert_array_equal(
                    _np(getattr(sh, name)), _jax_shard(ref, name, s, n).astype(
                        _np(getattr(sh, name)).dtype), f"{name} {s} of {n}")
        s, i = tsharded.sharded_ivf_search(cpu_mesh(n), got, q, k=K)
        np.testing.assert_array_equal(i, i8, f"{n} slots")
        np.testing.assert_array_equal(s, s8, f"{n} slots")
    one = tsharded.load_ivf_sharded(out, device="cpu")  # no mesh: one device, as before
    assert isinstance(one, tivf.IVFIndex) and one.buckets.shape[0] == 32
    with pytest.raises(ValueError, match="divide"):
        tsharded.load_ivf_sharded(out, mesh=cpu_mesh(3))


def test_shard_ivf_and_build_refuse_a_shard_count_that_does_not_divide(data):
    x, _, store = data
    whole = tivf.ivf_index_from_jax(jivf.build_ivf(x[:400], nlist=12, nprobe=2), "cpu")
    with pytest.raises(ValueError, match="divide"):
        tsharded.shard_ivf(cpu_mesh(), whole)
    with pytest.raises(ValueError, match="divide"):
        tsharded.build_ivf_from_store(cpu_mesh(), store, nlist=12)
    one = tsharded.shard_ivf(make_mesh(devices=["cpu"]), whole)  # one slot: the index itself
    assert isinstance(one, tivf.IVFIndex) and torch.equal(one.buckets, whole.buckets)
    partial = ShardedIVFIndex(cpu_mesh(1), (whole,), 2, n_shards=2)
    with pytest.raises(ValueError, match="every shard"):
        tsharded.sharded_ivf_search(cpu_mesh(1), partial, x[:2], k=3)


def test_one_slot_build_is_the_one_device_build(data, tmp_path):
    """A mesh of one slot builds one IVFIndex, which the one per-shard
    writer saves and the one re-splitting loader gives back onto one slot
    (the default mesh of ``device``) tensor for tensor."""
    _, _, store = data
    kw = dict(nlist=16, nprobe=4, seed=1, dtype="int8", chunk_rows=700)
    a = tsharded.build_ivf_from_store(make_mesh(devices=["cpu"]), store, **kw)
    assert isinstance(a, tivf.IVFIndex)
    tsharded.save_ivf_sharded(a, str(tmp_path / "one"))
    assert json.loads((tmp_path / "one" / "ivf_sharded_meta.json").read_text())["n_shards"] == 1
    b = tsharded.load_ivf_sharded(str(tmp_path / "one"), device="cpu")
    assert isinstance(b, tivf.IVFIndex)
    for name in tivf.ARRAYS + tivf.SIDECARS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), name


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    from haconvdr_tpu.config import DataConfig, ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.utils.testing import HashTokenizer

    cfg = ModelConfig.tiny(vocab_size=512)
    rng = np.random.RandomState(8)
    x = _mixture(rng, 600, cfg.embedding_dim, n_modes=12) * 4.0
    return dict(tok=HashTokenizer(cfg.vocab_size), cfg=cfg, params=init_params_numpy(cfg, 11),
                store=_write_store(tmp_path_factory.mktemp("sivf_serve") / "emb", x),
                data_cfg=DataConfig(is_train=False, use_PRL=False, max_query_length=12,
                                    max_doc_length=16, max_response_length=8,
                                    max_concat_length=32))


QUESTIONS = [("what is the capital of france", [("who wrote hamlet", "shakespeare")]),
             ("tell me about rivers", [])]


def test_ivf_retriever_on_a_mesh_builds_jax_nlist(serving, tmp_path):
    """Retriever(ivf=True) on 8 slots rounds nlist to the shard count as
    JAX's on 8 devices does (600 rows: min(1024, 75) = 75 -> 72 clusters)
    and probes them all when asked for >= 75; it answers as JAX's, saves
    8 shards and reloads them onto 8 slots and onto one device bit for
    bit; one slot keeps min(1024, 75) clusters."""
    from haconvdr_tpu.config import SearchConfig
    from haconvdr_tpu.serve import Retriever as JaxRetriever
    from haconvdr_torch.serve import Retriever

    args = (serving["tok"], serving["params"], serving["cfg"], serving["store"])
    kw = dict(data_cfg=serving["data_cfg"], ivf=True, ivf_nprobe=100, store_dtype="bfloat16",
              search_cfg=SearchConfig(top_k=8, per_device_test_batch_size=2))
    jr = JaxRetriever(*args, **kw)
    tr = Retriever(*args, mesh=cpu_mesh(), ivf_dir=str(tmp_path / "ivf"), **kw)
    assert jr.ivf_index.centroids.shape[0] == 72 == tr.ivf_index.nlist
    assert tr.ivf_index.nprobe == 72 and isinstance(tr.ivf_index, ShardedIVFIndex)
    meta = json.loads((tmp_path / "ivf" / "ivf_sharded_meta.json").read_text())
    assert meta["n_shards"] == 8 and meta["nlist"] == 72 and meta["corpus_rows"] == 600
    re8 = Retriever(*args, mesh=cpu_mesh(), ivf_dir=str(tmp_path / "ivf"), **kw)
    re1 = Retriever(*args, device="cpu", ivf_dir=str(tmp_path / "ivf"), **kw)
    assert re8.ivf_index.nprobe == 72 == re1.ivf_index.nprobe
    for qn, h in QUESTIONS:
        ours, ref = tr.retrieve(qn, h), jr.retrieve(qn, h)
        s = np.array([[x for _, x in ours]])
        i = np.array([[p for p, _ in ours]])
        assert_search_equal(s, i, np.array([[x for _, x in ref]]),
                            np.array([[p for p, _ in ref]]), qn)
        for again in (re8, re1):
            assert again.retrieve(qn, h) == ours
    one = Retriever(*args, device="cpu", **kw)  # one slot: min(1024, 75) clusters
    assert one.ivf_index.centroids.shape[0] == 75


def test_cli_device_mesh():
    from haconvdr_torch.cli._args import device_mesh

    assert device_mesh("cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            device_mesh("cuda")
