"""The multi-device layer of the PyTorch port (haconvdr_torch/parallel/mesh.py,
sharded_search.py, sharded_encode.py; encode_corpus and Retriever on a
mesh) against the JAX package on its 8-device virtual CPU mesh
(tests/conftest.py), with the port's mesh of 8 CPU slots
(``make_mesh(devices=["cpu"] * 8)``).  It covers tests/test_parallel.py's
cases but the tensor-parallel one, which the port does not have.

Tolerances:
* "grid" rows and queries are Gaussian draws rounded to multiples of 2**-8
  and clipped to [-3, 3] at D 16: every product and partial sum is exact
  in float32 (below 2**8 in magnitude), so any summation order gives the
  same bits, and the scores of either package are bit-equal in float32,
  bfloat16 (both round the same values) and int8, ids identical at every
  position;
* Gaussian rows: ids identical wherever adjacent scores differ by more
  than 1e-5 |s|; scores within 1e-5 |ref| (float32) and 1e-4 |ref|
  (bfloat16);
* int8 at k <= 128 scores int8 x int8 (the kernel path's model, as the
  one-shard port does), which the JAX CPU path does not: it is held bit
  for bit to that model's oracle on the port's own shards, whose codes
  and scales equal JAX's bit for bit; at k 300 both packages score the
  bfloat16-rounded folded query and are held to each other;
* the data-parallel encode: each row bit-equal to the same row encoded on
  one device in a batch of the slot's shape; within 1e-5 of JAX's
  GSPMD encode (tests/test_parallel.py's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.config import ModelConfig as JaxModelConfig
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.models.encoder import init_encoder_params
from haconvdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from haconvdr_tpu.parallel.sharded_encode import make_sharded_encode_fn, shard_params
from haconvdr_tpu.parallel.sharded_search import ShardedIndex as JaxIndex
from haconvdr_tpu.parallel.sharded_search import sharded_topk as jax_sharded_topk
from haconvdr_torch.config import ModelConfig
from haconvdr_torch.index.quantize import quantize_queries_int8
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.ops import topk_v4
from haconvdr_torch.parallel import mesh as tmesh
from haconvdr_torch.parallel import sharded_search as tsearch
from haconvdr_torch.parallel.mesh import make_mesh
from haconvdr_torch.parallel.sharded_encode import dp_encode_fn, encode_batches
from haconvdr_torch.parallel.sharded_search import ShardedIndex, sharded_topk


def cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


def _rows(rng, kind, n, d):
    x = rng.randn(n, d)
    if kind == "grid":
        x = np.clip(np.round(x * 256) / 256, -3, 3)
    return x.astype(np.float32)


def _separated(s):
    s = np.asarray(s, np.float64)
    gap = np.abs(np.diff(s, axis=1)) > 1e-5 * np.abs(s[:, 1:])
    left = np.concatenate([np.ones((len(s), 1), bool), gap], 1)
    right = np.concatenate([gap, np.ones((len(s), 1), bool)], 1)
    return left & right


def _same(s, i, rs, ri, kind, rtol, what=""):
    if kind == "grid":
        np.testing.assert_array_equal(s, rs, err_msg=what)
        np.testing.assert_array_equal(i, ri, err_msg=what)
        return
    np.testing.assert_allclose(s, rs, rtol=rtol, atol=1e-6, err_msg=what)
    sep = _separated(rs)
    assert sep.mean() > 0.5, what
    np.testing.assert_array_equal(np.asarray(i)[sep], np.asarray(ri)[sep], err_msg=what)


def _int8_oracle(index, q, k):
    """Each non-empty shard's int8 x int8 scores (its scale folded into the
    queries, per-query codes, exact integers, dequantized), ties to the
    lower global row, merged over the shards."""
    qt = torch.from_numpy(q)
    cols_s, cols_i = [], []
    for sh in index.shards:
        if sh.passages.shape[0] == 0:
            continue
        q8, q_scale = quantize_queries_int8(qt * sh.scale)
        full = q8.numpy().astype(np.int64) @ sh.passages.numpy().astype(np.int64).T
        s = torch.from_numpy(full.astype(np.float32)) * (q_scale[:, None] / 127.0)
        cols_s.append(s.numpy())
        cols_i.append(np.broadcast_to(sh.base + np.arange(full.shape[1]), full.shape))
    s, i = np.concatenate(cols_s, 1), np.concatenate(cols_i, 1)
    order = np.lexsort((i, -s.astype(np.float64)), axis=1)[:, :k]
    return np.take_along_axis(s, order, 1), np.take_along_axis(i, order, 1)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_slots_and_helpers():
    m = make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"dp": 8, "tp": 1} and m.size == 8 and m.axis_names == ("dp", "tp")
    assert m.slots == [torch.device("cpu")] * 8 and m.distinct == [torch.device("cpu")]
    assert make_mesh(dp=2, tp=4, devices=["cpu"] * 8).devices.shape == (2, 4)
    assert make_mesh(tp=2, devices=["cpu"] * 8).shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError, match="dp\\*tp"):
        make_mesh(dp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(tp=3, devices=["cpu"] * 8)
    if not torch.cuda.is_available():  # the default mesh is every card, or raises
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
    x = torch.arange(10).reshape(5, 2)
    parts = tmesh.shard_batch(make_mesh(devices=["cpu"] * 4), x)
    assert [p.shape[0] for p in parts] == [2, 2, 1, 0]  # ceil(5 / 4) a slot, as GSPMD
    assert torch.equal(torch.cat(parts), x)
    assert tmesh.batch_slices(1, 4) == [(0, 1), (1, 1), (1, 1), (1, 1)]
    reps = tmesh.replicate(m, torch.ones(3))
    assert len(reps) == 8 and all(r is reps[0] for r in reps)  # one copy a device
    enc = torch.nn.Linear(2, 2)
    assert all(r is enc for r in tmesh.replicate(m, enc))
    assert tmesh.pad_to_multiple(13, 8) == 16
    assert tmesh.dist_rank_world() == (0, 1)


# ---------------------------------------------------------------------------
# flat search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_ids", [False, True], ids=["offsets", "ids"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["grid", "gauss"])
def test_sharded_index_matches_jax(rng, kind, dtype, with_ids):
    """ShardedIndex on 8 slots against JAX's on 8 devices
    (tests/test_parallel.py:18-42 at n 1111, chunk 64): the same shard cut
    and int8 codes and scales, and the same answers."""
    n, d, q, k = 1111, 16, 6, 17
    emb, queries = _rows(rng, kind, n, d), _rows(rng, kind, q, d)
    ids = (np.arange(n) * 7 + 3).astype(np.int64) if with_ids else None
    ref = JaxIndex(jax_make_mesh(), emb, ids=ids, chunk=64, dtype=dtype)
    ours = ShardedIndex(cpu_mesh(), emb, ids=ids, chunk=64, dtype=dtype)
    jp = np.asarray(ref.passages.astype(jnp.float32))
    shard_rows = jp.shape[0] // 8
    assert shard_rows == tsearch.shard_row_count(n, 8, 64) == 192
    for s, sh in enumerate(ours.shards):
        assert sh.base == s * shard_rows
        rows = sh.passages.float().numpy()
        np.testing.assert_array_equal(rows, jp[sh.base : sh.base + rows.shape[0]])
        assert not jp[sh.base + rows.shape[0] : (s + 1) * shard_rows].any()  # JAX's pad
    assert [sh.passages.shape[0] for sh in ours.shards] == [192] * 5 + [151, 0, 0]
    if dtype == "int8":
        np.testing.assert_array_equal(ours.scales.numpy(), np.asarray(ref.scales))
        s, i = ours.search(queries, k)
        os_, oi = _int8_oracle(ours, queries, k)
        if ids is not None:
            oi = ids[oi]
        np.testing.assert_array_equal(s, os_)
        np.testing.assert_array_equal(i, oi)
        return
    s, i = ours.search(queries, k)
    rs, ri = ref.search(queries, k)
    _same(s, i, rs, ri, kind, 1e-5 if dtype == "float32" else 1e-4, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_index_k300_matches_jax(rng, dtype):
    """k 300 > 128 takes the plain path on every shard (no kernel), with
    the shards' k-lists longer than their rows: padded with empty slots
    that the merge drops.  int8 scores the bfloat16-rounded folded query
    in both packages here."""
    n, d = 1111, 16
    emb, queries = _rows(rng, "grid", n, d), _rows(rng, "grid", 5, d)
    ref = JaxIndex(jax_make_mesh(), emb, chunk=64, dtype=dtype)
    ours = ShardedIndex(cpu_mesh(), emb, chunk=64, dtype=dtype)
    s, i = ours.search(queries, 300)
    rs, ri = ref.search(queries, 300)
    _same(s, i, rs, ri, "grid", 0, dtype)
    assert (i >= 0).all()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_small_corpus_leaves_later_shards_empty(rng, dtype):
    """A corpus under one chunk lands whole in shard 0 (JAX's cut): the
    seven empty shards launch nothing, and an empty int8 shard still
    carries the scale JAX gives its all-zero shard."""
    n, d = 300, 8
    emb, queries = _rows(rng, "grid", n, d), _rows(rng, "grid", 4, d)
    ref = JaxIndex(jax_make_mesh(), emb, chunk=65536, dtype=dtype)
    ours = ShardedIndex(cpu_mesh(), emb, chunk=65536, dtype=dtype)
    assert [sh.passages.shape[0] for sh in ours.shards] == [300] + [0] * 7
    if dtype == "int8":
        jscales = np.asarray(ref.scales)
        np.testing.assert_array_equal(ours.scales.numpy(), jscales)
        np.testing.assert_array_equal(jscales[1:], np.ones((7, d), np.float32))
    before = topk_v4.COUNTS["plain"]
    s, i = ours.search(queries, 9)
    d8 = topk_v4.COUNTS["plain"] - before
    before = topk_v4.COUNTS["plain"]
    ShardedIndex(make_mesh(devices=["cpu"]), emb, chunk=65536, dtype=dtype).search(queries, 9)
    assert d8 == topk_v4.COUNTS["plain"] - before > 0  # shard 0 alone ran
    if dtype == "float32":
        rs, ri = ref.search(queries, 9)
        _same(s, i, rs, ri, "grid", 0)
    else:
        os_, oi = _int8_oracle(ours, queries, 9)
        np.testing.assert_array_equal(s, os_)
        np.testing.assert_array_equal(i, oi)


def test_int8_shard_of_zero_rows(rng):
    """A shard whose rows are all zero (not empty): scale 1 in every
    dimension in both packages, codes 0, and its rows score 0."""
    n, d = 640, 8
    emb = _rows(rng, "grid", n, d)
    emb[128:256] = 0.0  # shard 1 of chunk 64 x ceil(80 / 64) = 128 rows
    ref = JaxIndex(jax_make_mesh(), emb, chunk=64, dtype="int8")
    ours = ShardedIndex(cpu_mesh(), emb, chunk=64, dtype="int8")
    np.testing.assert_array_equal(ours.scales.numpy(), np.asarray(ref.scales))
    assert torch.equal(ours.shards[1].scale, torch.ones(d))
    assert not ours.shards[1].passages.any()
    q = _rows(rng, "grid", 3, d)
    s, i = ours.search(q, 640)
    rs, ri = ref.search(q, 640)
    _same(s, i, rs, ri, "grid", 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_from_store_equals_the_tensor_build_and_jax(rng, tmp_path, dtype):
    """ShardedIndex.from_store(mesh, store) (tests/test_parallel.py:87-127,
    three blocks, chunk 16): rows stream into the shards that own them, the
    shards equal the in-memory build's, and the answers JAX's."""
    n, d = 530, 8
    emb = _rows(rng, "grid", n, d)
    ids = (np.arange(n) * 2 + 1).astype(np.int64)
    store = EmbeddingBlockStore(str(tmp_path / "blk"))
    for b, (a, z) in enumerate([(0, 200), (200, 430), (430, n)]):
        store.write_block(b, emb[a:z], ids[a:z])
    ours = ShardedIndex.from_store(cpu_mesh(), store, chunk=16, dtype=dtype)
    built = ShardedIndex(cpu_mesh(), emb, ids=ids, chunk=16, dtype=dtype)
    assert ours.n_valid == n and np.array_equal(ours.ids, ids)
    for a, b in zip(ours.shards, built.shards):
        assert a.base == b.base and torch.equal(a.passages, b.passages)
        assert (a.scale is None) == (b.scale is None)
        assert a.scale is None or torch.equal(a.scale, b.scale)
    ref = JaxIndex.from_store(jax_make_mesh(), store, chunk=16, dtype=dtype)
    q = _rows(rng, "grid", 6, d)
    s, i = ours.search(q, 150)  # the plain path: both packages' scoring model
    rs, ri = ref.search(q, 150)
    _same(s, i, rs, ri, "grid", 0, dtype)
    s2, i2 = built.search(q, 11)
    s3, i3 = ours.search(q, 11)
    np.testing.assert_array_equal(s2, s3)
    np.testing.assert_array_equal(i2, i3)


def test_from_store_dequantizes_int8_blocks(rng, tmp_path):
    """int8 store blocks are dequantized as they are read, as JAX's
    from_store does."""
    from haconvdr_tpu.index.quantize import quantize_int8

    emb = _rows(rng, "gauss", 300, 8)
    store = EmbeddingBlockStore(str(tmp_path / "q"))
    for b in range(2):
        codes, scale = quantize_int8(emb[b * 150 : (b + 1) * 150])
        store.write_block(b, codes, np.arange(b * 150, (b + 1) * 150), scale=scale)
    ours = ShardedIndex.from_store(cpu_mesh(), store, chunk=16)
    ref = JaxIndex.from_store(jax_make_mesh(), store, chunk=16)
    np.testing.assert_array_equal(
        torch.cat([sh.passages for sh in ours.shards]).numpy(),
        np.asarray(ref.passages)[np.concatenate([np.arange(sh.base, sh.base + sh.passages.shape[0])
                                                 for sh in ours.shards])])
    q = _rows(rng, "gauss", 4, 8)
    _same(*ours.search(q, 7), *ref.search(q, 7), "gauss", 1e-5)


@pytest.mark.parametrize("kernel", ["v4", "v3"])
def test_sharded_topk_matches_jax_on_its_padded_layout(rng, kernel):
    """sharded_topk on JAX's own layout (8 shards of 1,024 rows, n_valid
    7,777 cutting the last shard; tests/test_parallel.py:130-156): each
    kernel against JAX's chunked path, scores and global ids."""
    mesh = cpu_mesh()
    n_valid, d, q, k = 7_777, 32, 128, 23
    passages = np.zeros((8 * 1024, d), np.float32)
    passages[:n_valid] = rng.randn(n_valid, d)
    queries = rng.randn(q, d).astype(np.float32)
    rs, ri = jax_sharded_topk(jax_make_mesh(), jnp.asarray(queries), jnp.asarray(passages),
                              n_valid, k, chunk=1024, use_pallas=False)
    shards = list(torch.from_numpy(passages).split(1024))
    s, i = sharded_topk(mesh, torch.from_numpy(queries), shards, n_valid, k, chunk=1024,
                        kernel=kernel)
    assert int(i.max()) < n_valid
    _same(s.numpy(), i.numpy(), np.asarray(rs), np.asarray(ri), "gauss", 1e-5, kernel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_one_slot_mesh_is_the_one_device_index(rng, tmp_path, dtype):
    """A mesh of one slot is the one-shard index every single-device
    caller builds: the same rows, the same answers, the same launches."""
    emb = _rows(rng, "gauss", 700, 16)
    q = _rows(rng, "gauss", 5, 16)
    one = ShardedIndex(make_mesh(devices=["cpu"]), emb, dtype=dtype)
    old = ShardedIndex.from_tensor(torch.from_numpy(emb), dtype=dtype)
    store = EmbeddingBlockStore(str(tmp_path / "s"))
    store.write_block(0, emb, np.arange(700))
    st_new = ShardedIndex.from_store(make_mesh(devices=["cpu"]), store, dtype=dtype)
    assert len(one.shards) == 1 and one.mesh.size == 1
    for a in (one, st_new):
        assert torch.equal(a.passages, old.passages) if dtype != "int8" else \
            torch.equal(a.passages.float() * a.scale, old.passages.float() * old.scale)
    answers = []
    for idx in (old, one, st_new):
        before = dict(topk_v4.COUNTS)
        answers.append(idx.search(q, 10))
        answers[-1] += ({key: topk_v4.COUNTS[key] - before[key] for key in before},)
    for a in answers[1:]:
        np.testing.assert_array_equal(a[1], answers[0][1])
        assert a[2] == answers[0][2]  # the same launches
        if dtype != "int8":
            np.testing.assert_array_equal(a[0], answers[0][0])


def test_every_v4_search_launches_before_any_finishes(rng, monkeypatch):
    """The per-shard v4 searches are all launched before the first host
    sync, so on several cards no shard waits for another's n_flag."""
    events = []
    real_launch, real_finish = tsearch.block_topk_launch, tsearch.block_topk_finish
    monkeypatch.setattr(tsearch, "block_topk_launch",
                        lambda *a, **kw: events.append("launch") or real_launch(*a, **kw))
    monkeypatch.setattr(tsearch, "block_topk_finish",
                        lambda st: events.append("finish") or real_finish(st))
    emb = _rows(rng, "gauss", 2000, 16)
    idx = ShardedIndex(make_mesh(devices=["cpu"] * 4), emb, chunk=256)
    idx.search(_rows(rng, "gauss", 3, 16), 10)
    assert events == ["launch"] * 4 + ["finish"] * 4


def test_empty_and_mismatched_meshes_refuse(rng):
    emb = _rows(rng, "gauss", 100, 8)
    with pytest.raises(ValueError, match="shards for a mesh"):
        sharded_topk(cpu_mesh(), torch.zeros(1, 8), [torch.from_numpy(emb)], 100, 5)
    with pytest.raises(ValueError, match="kernel"):
        ShardedIndex(cpu_mesh(), emb, kernel="v2")
    idx = ShardedIndex(cpu_mesh(), emb)
    with pytest.raises(AttributeError, match="shards"):
        idx.passages  # noqa: B018


# ---------------------------------------------------------------------------
# data-parallel encode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tower():
    from haconvdr_torch.models.convert import init_params_numpy

    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=4)
    return cfg, params, AnceEncoder.from_jax_params(params, cfg, "cpu")


def _one_device_at(encoder, ids, mask, per):
    """Each ``per``-row slice encoded on one device (a short last slice
    padded with copies of the batch's first row, as the slots pad it)."""
    outs = []
    for a in range(0, ids.shape[0], per):
        x, m = ids[a : a + per], mask[a : a + per]
        n = x.shape[0]
        if n < per:
            x = torch.cat([x, ids[:1].expand(per - n, -1)])
            m = torch.cat([m, mask[:1].expand(per - n, -1)])
        outs.append(encoder(x, m)[:n])
    return torch.cat(outs)


@pytest.mark.parametrize("B", [16, 12, 3])
def test_dp_encode_equals_one_device_at_the_slot_shape(rng, tower, B):
    """The batch cut over 8 dp slots: each row bit-equal to its slice
    encoded on one device at the slot's shape (ceil(B / 8) rows), and
    within 1e-5 of JAX's GSPMD encode on 8 devices (tests/test_parallel.py:45-57)."""
    cfg, params, enc = tower
    L = 10
    ids = torch.from_numpy(rng.randint(4, cfg.vocab_size, size=(B, L)).astype(np.int32))
    mask = torch.ones((B, L), dtype=torch.int32)
    mask[1, 6:] = 0
    fn = dp_encode_fn(cpu_mesh(), enc)
    with torch.inference_mode():
        got = fn(ids, mask)
        want = _one_device_at(enc, ids, mask, -(-B // 8))
    assert torch.equal(got, want)
    jcfg = JaxModelConfig.tiny()
    jmesh = jax_make_mesh(dp=8, tp=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(make_sharded_encode_fn(jmesh, jcfg)(shard_params(jmesh, jp),
                                                          jnp.asarray(ids.numpy()),
                                                          jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_dp_encode_skips_slices_of_padding_and_refuses_tp(tower):
    cfg, _, enc = tower
    calls = []

    def fn(x, m):
        calls.append(x.shape[0])
        return enc(x, m)

    ids = torch.randint(4, cfg.vocab_size, (8, 6), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    mask = torch.ones_like(ids)
    valid = np.array([1, 1, 1, 0, 0, 0, 0, 0], bool)
    with torch.inference_mode():
        out = dp_encode_fn(make_mesh(devices=["cpu"] * 4), fn)(ids, mask, valid)
    assert calls == [2, 2]  # slices 3 and 4 hold only padding
    assert not out[4:].any()
    # a dp x tp mesh with replicated params (JAX's get_test_query_embeddings
    # case): each dp row runs one of its tp slots, and the rows equal the
    # dp-only mesh's of the same slice shape
    calls.clear()
    with torch.inference_mode():
        tp_out = dp_encode_fn(make_mesh(tp=2, devices=["cpu"] * 4), fn)(ids, mask, valid)
        ref = dp_encode_fn(make_mesh(devices=["cpu"] * 2), enc)(ids, mask, valid)
    assert calls == [4]  # two dp slices of 4 rows; the second holds only padding
    assert torch.equal(tp_out, ref)


def test_encode_batches_on_a_mesh(tower):
    """encode_batches(..., mesh) over collated batches: the valid rows,
    each at the slot shape, and the sample ids in order."""
    from haconvdr_torch.data.loader import batch_iter

    cfg, _, enc = tower
    r = np.random.RandomState(3)
    examples = [{"sample_id": f"s{j}", "x": r.randint(4, cfg.vocab_size, 9).astype(np.int32),
                 "x_mask": np.ones(9, np.int32)} for j in range(21)]
    got, ids = encode_batches(enc, batch_iter(examples, 16), "x", "x_mask",
                              mesh=cpu_mesh())
    assert ids == [e["sample_id"] for e in examples] and got.shape == (21, cfg.embedding_dim)
    with torch.inference_mode():
        for b0 in (0, 16):
            batch = examples[b0 : b0 + 16]
            x = torch.from_numpy(np.stack([e["x"] for e in batch]
                                          + [batch[0]["x"]] * (16 - len(batch))))
            want = _one_device_at(enc, x, torch.ones_like(x), 2)[: len(batch)]
            np.testing.assert_array_equal(got[b0 : b0 + len(batch)], want.numpy())


def test_two_host_encode_simulation_on_a_mesh(rng, tmp_path, tower):
    """tests/test_parallel.py:159-201 on the port: two stride/offset passes
    of encode_corpus on an 8-slot mesh write disjoint block ranges into one
    store; stitched, they equal the single pass, offset for offset, and
    each row equals the one-device encode at the slot shape (batch 8 over 8
    slots: one row a slot)."""
    from haconvdr_torch.index.build import encode_corpus
    from haconvdr_torch.index.store import (
        EmbeddingBlockStore as TStore,
        TokenizedCorpus,
        TokenizedCorpusWriter,
    )

    cfg, _, enc = tower
    L, n = 10, 53
    w = TokenizedCorpusWriter(str(tmp_path / "tok"), L)
    for i in range(n):
        w.add(1000 + i, rng.randint(4, cfg.vocab_size, size=rng.randint(3, L + 1)).tolist())
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "tok"))
    kw = dict(batch_size=8, per_block_passage_num=16, mesh=cpu_mesh())
    encode_corpus(corpus, enc, str(tmp_path / "single"), **kw)
    shared = str(tmp_path / "shared")
    encode_corpus(corpus, enc, shared, stride=2, offset=0, start_block_id=0, **kw)
    encode_corpus(corpus, enc, shared, stride=2, offset=1, start_block_id=2, **kw)
    encode_corpus(corpus, enc, str(tmp_path / "one"), batch_size=1, per_block_passage_num=16)

    def id_map(d):
        store, out = TStore(d), {}
        for b in range(store.num_blocks()):
            emb, ids = store.read_block(b)
            for row, off in zip(np.asarray(emb), np.asarray(ids)):
                assert int(off) not in out
                out[int(off)] = row
        return out

    single, stitched, one = (id_map(str(tmp_path / x)) for x in ("single", "shared", "one"))
    assert set(single) == set(stitched) == set(one) == set(range(n))
    for off in single:
        np.testing.assert_array_equal(single[off], stitched[off])
        np.testing.assert_array_equal(single[off], one[off])


# ---------------------------------------------------------------------------
# Retriever on a mesh
# ---------------------------------------------------------------------------

def test_retriever_on_a_mesh_matches_jax(tmp_path):
    """Retriever(mesh=8 slots) against JAX's Retriever on its 8 devices:
    JAX's embed batch (max(n_dev, per-device batch x n_dev) rows), a
    sharded resident index in each dtype, the same ranked pids, scores
    within 1e-5; BatchingRetriever answers equal Retriever.search of the
    same requests encoded at the slot shape of their dispatch."""
    from haconvdr_tpu.config import DataConfig, SearchConfig
    from haconvdr_tpu.serve import Retriever as JaxRetriever
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.serve import BatchingRetriever, Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    cfg = ModelConfig.tiny(vocab_size=512)
    params = init_params_numpy(cfg, seed=11)
    r = np.random.RandomState(5)
    store = EmbeddingBlockStore(str(tmp_path / "emb"))
    for b in range(2):
        store.write_block(b, r.randn(60, cfg.embedding_dim).astype(np.float32),
                          np.arange(b * 60, (b + 1) * 60))
    data_cfg = DataConfig(is_train=False, use_PRL=False, max_query_length=12,
                          max_doc_length=16, max_response_length=8, max_concat_length=32)
    kw = dict(data_cfg=data_cfg, search_cfg=SearchConfig(top_k=8, per_device_test_batch_size=2))
    tok = HashTokenizer(cfg.vocab_size)
    queries = [("what is the capital of france", [("who wrote hamlet", "shakespeare")]),
               ("tell me about rivers", []), ("and the longest", [("rivers", "the nile")])]
    jr = JaxRetriever(tok, params, cfg, store, **kw)
    tr = Retriever(tok, params, cfg, store, mesh=cpu_mesh(), **kw)
    assert tr.mesh.size == 8 and len(tr.index.shards) == 8
    for qn, h in queries:
        ours, ref = tr.retrieve(qn, h), jr.retrieve(qn, h)
        assert [p for p, _ in ours] == [p for p, _ in ref]
        np.testing.assert_allclose([s for _, s in ours], [s for _, s in ref], rtol=1e-5,
                                   atol=1e-5)
    exs = [tr.build_query(qn, h) for qn, h in queries]
    with torch.inference_mode():
        # min(max(8, 2 x 8), max(3, 8)) = 8 rows: one a slot
        x = torch.from_numpy(np.stack([e["conv_qp"] for e in exs] + [exs[0]["conv_qp"]] * 5))
        m = torch.from_numpy(np.stack([e["conv_qp_mask"] for e in exs]
                                      + [exs[0]["conv_qp_mask"]] * 5))
        want = _one_device_at(tr.encoder, x, m, 1)[:3].numpy()
    np.testing.assert_array_equal(tr.embed(exs), want)
    with BatchingRetriever(tr, max_batch=4, max_wait_ms=50.0) as br:
        futs = [br.submit(qn, h) for qn, h in queries]
        got = [f.result(timeout=120) for f in futs]
    for e, hits in zip(exs, got):  # dispatches of <= 4 over 8 slots: one row a slot
        with torch.inference_mode():
            one = tr.encoder(torch.tensor([e["conv_qp"]], dtype=torch.int32),
                             torch.tensor([e["conv_qp_mask"]], dtype=torch.int32)).numpy()
        s, i = tr.search(one)
        assert [p for p, _ in hits] == [int(p) for p in i[0]]
        np.testing.assert_allclose([x for _, x in hits], s[0], rtol=1e-5, atol=1e-6)
    for dtype in ("bfloat16", "int8"):
        jr8 = JaxRetriever(tok, params, cfg, store, store_dtype=dtype, **kw)
        tr8 = Retriever(tok, params, cfg, store, store_dtype=dtype, mesh=cpu_mesh(), **kw)
        for qn, h in queries:
            ours, ref = tr8.retrieve(qn, h), jr8.retrieve(qn, h)
            assert [p for p, _ in ours][:4] == [p for p, _ in ref][:4], dtype
