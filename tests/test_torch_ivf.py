"""The IVF serving tier of the PyTorch port (haconvdr_torch/index/ivf.py,
parallel/sharded_ivf.py, Retriever(ivf=True), cli/build_ivf, cli/ivf_sweep,
cli/ivf_geometry_check) against the JAX package, on the CPU, at
tests/test_ivf.py's sizes: Gaussian mixtures from np.random.RandomState.

Tolerances:
* search on one index: the same ids wherever adjacent scores differ by
  more than 1e-5 |s| (below that two float32 sums in another order may
  swap two near-equal rows), scores within 1e-5 relative;
* builds, with the port's k-means init patched to JAX's
  ``jax.random.choice`` rows (``_jax_init``): centroids within rtol 1e-5
  and the same bucket ids; the tail as a set (JAX's own tests allow its
  order to differ);
* int8 (``quantize_ivf`` and the store build): the global scheme's scale
  and codes are identical (an exact amax; the scale computed as JAX's
  jit or its host computes it; one IEEE division); residual codes may
  differ by one code, and only where JAX's unrounded value lies within
  the means' (and scales') difference of a .5 boundary, since the two
  packages sum the cluster means in another order and precision.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.index import ivf as jivf
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.parallel import sharded_ivf as jsharded
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_torch.index import ivf as tivf
from haconvdr_torch.parallel import sharded_ivf as tsharded
from haconvdr_torch.parallel.mesh import make_mesh as torch_make_mesh

K = 10
CPU1 = torch_make_mesh(devices=["cpu"])  # the one-slot mesh of the CPU


def _mixture(rng, n, d, n_modes=16, spread=0.15):
    modes = rng.randn(n_modes, d).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    pick = rng.randint(0, n_modes, n)
    x = modes[pick] + spread * rng.randn(n, d).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _jax_init(n, k, seed):
    """JAX's k-means init rows (jax.random.choice under PRNGKey(seed))."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False))


@pytest.fixture()
def shared_init(monkeypatch):
    monkeypatch.setattr(tivf, "init_rows", _jax_init)


def _write_store(path, x, n_blocks=3):
    store = EmbeddingBlockStore(str(path))
    per = -(-x.shape[0] // n_blocks)
    for b in range(n_blocks):
        blk = x[b * per : (b + 1) * per]
        store.write_block(b, blk, np.arange(b * per, b * per + len(blk), dtype=np.int64))
    return store


def assert_search_equal(s, i, rs, ri, what=""):
    """Scores within 1e-5 relative; ids identical wherever the adjacent
    scores (both neighbours) differ by more than 1e-5 |s|."""
    s, rs = np.asarray(s, np.float64), np.asarray(rs, np.float64)
    assert s.shape == rs.shape and np.asarray(i).shape == np.asarray(ri).shape, what
    fin = np.isfinite(rs)
    assert (np.isfinite(s) == fin).all(), what
    np.testing.assert_allclose(s[fin], rs[fin], rtol=1e-5, atol=1e-6, err_msg=what)
    gap = np.abs(np.diff(rs, axis=1)) > 1e-5 * np.abs(rs[:, 1:])
    gap = np.where(np.isnan(gap), False, gap)
    left = np.concatenate([np.ones((len(rs), 1), bool), gap], axis=1)
    right = np.concatenate([gap, np.ones((len(rs), 1), bool)], axis=1)
    sep = left & right
    assert sep.mean() > 0.5, what
    np.testing.assert_array_equal(np.asarray(i)[sep], np.asarray(ri)[sep], err_msg=what)


def _exact(q, x, k):
    s = q.astype(np.float64) @ x.astype(np.float64).T
    i = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, i, 1), i


QUANT = {
    "float32": lambda idx: idx,
    "bfloat16": None,  # built at bfloat16
    "int8_global": lambda idx: jivf.quantize_ivf(idx, by_residual=False),
    "int8_residual": jivf.quantize_ivf,
}


@pytest.fixture(scope="module")
def jax_indexes():
    rng = np.random.RandomState(11)
    x = _mixture(rng, 3000, 32, n_modes=24)
    q = _mixture(rng, 6, 32, n_modes=24)
    f32 = jivf.build_ivf(x, nlist=32, nprobe=6, slack=1.3, seed=5)
    out = {"x": x, "q": q}
    for name, make in QUANT.items():
        out[name] = (
            jivf.build_ivf(x, nlist=32, nprobe=6, slack=1.3, seed=5, dtype="bfloat16")
            if make is None else make(f32)
        )
    return out


@pytest.mark.parametrize("nprobe", [6, 32], ids=["partial", "full"])
@pytest.mark.parametrize("dtype", list(QUANT))
def test_search_on_one_index_matches_jax(jax_indexes, dtype, nprobe):
    """One JAX-built index carried across with ivf_index_from_jax: the
    port's ivf_search answers as JAX's, in each bucket dtype; at full probe
    the float indexes equal the exact oracle."""
    q, x = jax_indexes["q"], jax_indexes["x"]
    jidx = jax_indexes[dtype]
    tidx = tivf.ivf_index_from_jax(jidx, "cpu")
    assert tidx.buckets.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        dtype, torch.int8)
    rs, ri = jivf.ivf_search(jidx, q, k=K, nprobe=nprobe)
    s, i = tivf.ivf_search(tidx, q, k=K, nprobe=nprobe)
    assert s.dtype == np.float32 and i.dtype == np.int32
    assert_search_equal(s, i, rs, ri, dtype)
    s2, i2 = tsharded.sharded_ivf_search(CPU1, tidx, q, k=K, nprobe=nprobe)
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)
    if nprobe == 32 and dtype in ("float32", "bfloat16"):
        xr, qr = x, q
        if dtype == "bfloat16":  # the bf16 scoring model: both sides rounded
            xr = torch.from_numpy(x).bfloat16().float().numpy()
            qr = torch.from_numpy(q).bfloat16().float().numpy()
        es, ei = _exact(qr, xr, K)
        assert_search_equal(s, i, es, ei, dtype + " exact")


def test_residual_int8_is_exact_at_zero_residual(rng):
    """Every row equal to its cluster mean: the residual codes are 0 and the
    scores are the exact q . mean corrections (test_ivf.py:510)."""
    d, nlist, cap = 16, 8, 16
    centers = rng.normal(size=(nlist, d)).astype(np.float32) * 3.0
    index = tivf.IVFIndex(
        centroids=torch.from_numpy(centers / np.linalg.norm(centers, axis=1, keepdims=True)),
        buckets=torch.from_numpy(np.repeat(centers[:, None, :], cap, axis=1)),
        bucket_ids=torch.arange(nlist * cap, dtype=torch.int32).view(nlist, cap),
        tail=torch.zeros(8, d),
        tail_ids=torch.full((8,), -1, dtype=torch.int32),
        nprobe=nlist,
    )
    q = rng.normal(size=(5, d)).astype(np.float32)
    q8 = tivf.quantize_ivf(index)
    assert q8.buckets.dtype == torch.int8 and int(q8.buckets.abs().max()) == 0
    assert tivf.quantize_ivf(q8) is q8  # idempotent
    s_f, _ = tivf.ivf_search(index, q, k=4)
    s_r, _ = tivf.ivf_search(q8, q, k=4)
    np.testing.assert_allclose(s_r, s_f, rtol=1e-5, atol=1e-5)


def test_probe_groups_merge_as_one_panel(jax_indexes, monkeypatch):
    """A panel budget that splits the queries into batches and each batch's
    probes into groups gives the answer of one panel, bit for bit."""
    q = np.concatenate([jax_indexes["q"]] * 3)
    for dtype in ("bfloat16", "int8_residual"):
        tidx = tivf.ivf_index_from_jax(jax_indexes[dtype], "cpu")
        s0, i0 = tivf.ivf_search(tidx, q, k=K, nprobe=20)
        cap, D = tidx.buckets.shape[1:]
        monkeypatch.setattr(tivf, "PANEL_BYTES", 3 * cap * D * 4)  # 1 query, 3 probes
        s1, i1 = tivf.ivf_search(tidx, q, k=K, nprobe=20)
        monkeypatch.undo()
        np.testing.assert_array_equal(s1, s0)
        np.testing.assert_array_equal(i1, i0)


def test_search_refusals_and_clamps(rng):
    x = _mixture(rng, 64, 8)
    index = tivf.build_ivf(x, nlist=4, nprobe=99, device="cpu")
    assert index.nprobe == 4
    s, i = tivf.ivf_search(index, _mixture(rng, 2, 8), k=3)
    s2, _ = tivf.ivf_search(index, _mixture(rng, 2, 8), k=3, nprobe=50)
    assert s.shape == s2.shape == (2, 3)
    pool = index.buckets.shape[1] + index.tail.shape[0]
    jidx = jivf.build_ivf(x, nlist=4, nprobe=1)
    with pytest.raises(Exception):  # lax.top_k refuses k past its axis
        jivf.ivf_search(jidx, x[:2], k=pool + 1, nprobe=1)
    with pytest.raises(ValueError, match="exceeds"):
        tivf.ivf_search(index, x[:2], k=pool + 1, nprobe=1)
    with pytest.raises(ValueError, match="< nlist"):
        tivf.build_ivf(x, nlist=128, device="cpu")
    with pytest.raises(ValueError, match="< nlist"):
        tivf.build_ivf_device(torch.from_numpy(x), nlist=128)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        tivf.build_ivf(x, nlist=4, dtype="int8", device="cpu")
    # empty slots: fewer valid rows than k come back as (-inf, -1)
    small = tivf.build_ivf(x[:16], nlist=2, nprobe=1, device="cpu")
    s, i = tivf.ivf_search(small, x[:1], k=small.buckets.shape[1] + 8, nprobe=1)
    assert (i[np.isneginf(s)] == -1).all() and np.isneginf(s).any()


def test_spherical_kmeans_matches_jax(rng, shared_init):
    x = _mixture(rng, 512, 24)
    ref = np.asarray(jivf.spherical_kmeans(jnp.asarray(x), nlist=8, iters=5))
    got = tivf.spherical_kmeans(torch.from_numpy(x), 8, 5).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def _same_layout(ours, ref, what):
    np.testing.assert_allclose(ours.centroids.numpy(), np.asarray(ref.centroids), rtol=1e-5,
                               atol=1e-6, err_msg=what)
    np.testing.assert_array_equal(ours.bucket_ids.numpy(), np.asarray(ref.bucket_ids), what)
    np.testing.assert_array_equal(
        tivf.to_numpy(ours.buckets).astype(np.float32),
        np.asarray(ref.buckets, np.float32), what)
    ot, rt = ours.tail_ids.numpy(), np.asarray(ref.tail_ids)
    assert sorted(ot[ot >= 0].tolist()) == sorted(rt[rt >= 0].tolist()), what
    got = np.concatenate([ours.bucket_ids.numpy().ravel(), ot])
    assert len(got[got >= 0]) == len(set(got[got >= 0].tolist()))  # every row once


@pytest.mark.parametrize("build", ["host", "device", "store_f32", "store_bf16"])
def test_builds_match_jax_with_shared_init(rng, tmp_path, shared_init, build):
    """With JAX's init rows, each of the port's builds gives JAX's
    centroids and bucket layout (the host build's chunked fill, the device
    build's sort and the store build's passes), and the same answers."""
    n, d = 3000, 32
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    ids = np.arange(100, 100 + n, dtype=np.int32)
    if build == "host":
        ref = jivf.build_ivf(x, nlist=32, nprobe=6, slack=1.1, ids=ids, seed=3)
        ours = tivf.build_ivf(x, nlist=32, nprobe=6, slack=1.1, ids=ids, seed=3, device="cpu")
        assert ours.tail.shape == np.asarray(ref.tail).shape
        np.testing.assert_array_equal(ours.tail_ids.numpy(), np.asarray(ref.tail_ids))
    elif build == "device":
        ref = jivf.build_ivf_device(jnp.asarray(x), nlist=32, nprobe=6, slack=1.1,
                                    tail_frac=0.3, ids=jnp.asarray(ids), seed=3)
        ours = tivf.build_ivf_device(torch.from_numpy(x), nlist=32, nprobe=6, slack=1.1,
                                     tail_frac=0.3, ids=torch.from_numpy(ids), seed=3)
        assert ours.tail.shape == np.asarray(ref.tail).shape  # trimmed to the spill
        np.testing.assert_array_equal(ours.tail_ids.numpy(), np.asarray(ref.tail_ids))
    else:
        dtype = "float32" if build == "store_f32" else "bfloat16"
        store = _write_store(tmp_path / "store", x)
        ref = jsharded.build_ivf_from_store(make_mesh(), store, nlist=32, nprobe=6, slack=1.3,
                                            seed=5, dtype=dtype, chunk_rows=512)
        ours = tsharded.build_ivf_from_store(CPU1, store, nlist=32, nprobe=6, slack=1.3, seed=5,
                                             dtype=dtype, chunk_rows=512)
        assert ours.buckets.dtype == getattr(torch, dtype)
    _same_layout(ours, ref, build)
    rs, ri = jivf.ivf_search(ref, q, k=K) if build in ("host", "device") else \
        jsharded.sharded_ivf_search(make_mesh(), ref, q, k=K)
    s, i = tsharded.sharded_ivf_search(CPU1, ours, q, k=K)
    assert_search_equal(s, i, rs, ri, build)


def assert_residual_codes_close(ours, ref, rows, tail_rows, what=""):
    """Residual int8 against JAX's: means within 1e-6 relative, scales within
    1e-5, and codes (the buckets of float ``rows``, then ``tail_rows`` =
    (the port's tail codes, JAX's, the float rows), aligned) equal but for
    ones that differ by one where JAX's unrounded residual sits within the
    means' and scales' float32 difference of a .5 boundary."""
    means, scale = np.asarray(ref.means), np.asarray(ref.scale)
    np.testing.assert_allclose(ours.means.numpy(), means, rtol=1e-6, atol=1e-7, err_msg=what)
    for name in ("scale", "mu", "tail_scale"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=what)
    tail_ours, tail_ref, tail_float = tail_rows
    parts = [
        (ours.buckets.numpy(), np.asarray(ref.buckets), rows, means[:, None, :],
         scale[:, None, :], ours.means.numpy()[:, None, :], ours.scale.numpy()[:, None, :]),
        (tail_ours, tail_ref, tail_float, np.asarray(ref.mu), np.asarray(ref.tail_scale),
         ours.mu.numpy(), ours.tail_scale.numpy()),
    ]
    for oc, rc, b, m, sc, m_p, sc_p in parts:
        oc, rc = oc.astype(np.int32), rc.astype(np.int32)
        diff = oc != rc
        assert np.abs(oc - rc).max() <= 1 and diff.mean() < 1e-3, what
        r = (b - m) / sc
        slack = np.abs(m_p - m) / sc + np.abs(sc_p / sc - 1) * 128 + 1e-5
        off = np.abs(np.abs(r) - np.floor(np.abs(r)) - 0.5)
        assert (off[diff] <= np.broadcast_to(slack, r.shape)[diff]).all(), what


def _by_id(rows_or_codes, ids):
    """The valid rows of a tail, ordered by id."""
    v = ids >= 0
    return rows_or_codes[v][np.argsort(ids[v])]


def test_store_build_int8_matches_jax(rng, tmp_path, shared_init):
    """build_ivf_from_store at int8 against JAX's on its 8-device mesh: the
    global build's scale and codes are identical (an exact amax, one
    division); the residual build sums a chunk's rows in float32 in
    another order than JAX's host reduceat, so its codes agree but for
    ones at a .5 boundary.  The answers agree."""
    n, d = 2000, 32
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    store = _write_store(tmp_path / "store8", x)
    for by_residual in (True, False):
        kw = dict(nlist=16, nprobe=16, dtype="int8", chunk_rows=512, by_residual=by_residual)
        ref = jsharded.build_ivf_from_store(make_mesh(), store, **kw)
        ours = tsharded.build_ivf_from_store(CPU1, store, **kw)
        what = f"residual={by_residual}"
        np.testing.assert_array_equal(ours.bucket_ids.numpy(), np.asarray(ref.bucket_ids), what)
        # JAX deals the spill round-robin to its 8 shards' tails: match by id
        ot, rt = ours.tail_ids.numpy(), np.asarray(ref.tail_ids)
        assert sorted(ot[ot >= 0]) == sorted(rt[rt >= 0])
        if by_residual:
            ids = ours.bucket_ids.numpy()
            rows = np.where((ids >= 0)[..., None], x[np.clip(ids, 0, None)], 0.0)
            assert_residual_codes_close(
                ours, ref, rows,
                (_by_id(ours.tail.numpy(), ot), _by_id(np.asarray(ref.tail), rt),
                 x[np.sort(ot[ot >= 0])]), what)
        else:
            assert ours.means is None and ours.tail_scale is None
            np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
            np.testing.assert_array_equal(ours.buckets.numpy(), np.asarray(ref.buckets))
            np.testing.assert_array_equal(_by_id(ours.tail.numpy(), ot),
                                          _by_id(np.asarray(ref.tail), rt))
        rs, ri = jsharded.sharded_ivf_search(make_mesh(), ref, q, k=K)
        s, i = tsharded.sharded_ivf_search(CPU1, ours, q, k=K)
        assert_search_equal(s, i, rs, ri, what)


@pytest.mark.parametrize("by_residual", [False, True], ids=["global", "residual"])
def test_quantize_ivf_codes_match_jax(jax_indexes, by_residual):
    """quantize_ivf on one float index: the global scheme's scale and codes
    are identical; residual codes agree but for ones at a .5 boundary (the
    cluster means are float32 sums in another order)."""
    f32 = jax_indexes["float32"]
    ref = jivf.quantize_ivf(f32, by_residual=by_residual)
    ours = tivf.quantize_ivf(tivf.ivf_index_from_jax(f32, "cpu"), by_residual=by_residual)
    if not by_residual:
        np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
        np.testing.assert_array_equal(ours.buckets.numpy(), np.asarray(ref.buckets))
        np.testing.assert_array_equal(ours.tail.numpy(), np.asarray(ref.tail))
        return
    tail_ids = np.asarray(f32.tail_ids)
    tail = np.asarray(f32.tail, np.float32) * (tail_ids >= 0)[:, None]
    assert_residual_codes_close(
        ours, ref, np.asarray(f32.buckets, np.float32),
        (ours.tail.numpy(), np.asarray(ref.tail), tail), "quantize_ivf")


def test_device_build_overflow_raises_and_trims(rng):
    x = _mixture(rng, 400, 8, n_modes=1, spread=0.0)  # one cluster
    with pytest.raises(ValueError, match="IVF overflow"):
        tivf.build_ivf_device(torch.from_numpy(x), nlist=16, nprobe=4, slack=1.0, tail_frac=0.02)
    x = _mixture(rng, 2000, 16, n_modes=8)
    index = tivf.build_ivf_device(torch.from_numpy(x), nlist=8, nprobe=8, slack=1.05,
                                  tail_frac=0.5)
    n_spill = int((index.tail_ids >= 0).sum())
    assert index.tail.shape[0] == max(8, -(-n_spill // 8) * 8)
    q = _mixture(rng, 3, 16, n_modes=8)
    s, i = tivf.ivf_search(index, q, k=7)
    assert_search_equal(s, i, *_exact(q, x, 7), "trimmed")


# ---------------------------------------------------------------------------
# persistence across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def persist_store(tmp_path_factory):
    rng = np.random.RandomState(23)
    x = _mixture(rng, 3000, 32, n_modes=24)
    q = _mixture(rng, 6, 32, n_modes=24)
    store = _write_store(tmp_path_factory.mktemp("persist") / "store", x)
    return store, x, q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_jax_sharded_dir_loads_in_the_port(persist_store, tmp_path, dtype):
    """JAX's save_ivf_sharded on its 8-device mesh -> the port's
    load_ivf_sharded on one device: the answers of JAX's
    sharded_ivf_search."""
    store, _, q = persist_store
    mesh = make_mesh()
    built = jsharded.build_ivf_from_store(mesh, store, nlist=32, nprobe=6, slack=1.3, seed=5,
                                          dtype=dtype, chunk_rows=512)
    jsharded.save_ivf_sharded(built, str(tmp_path / "ivf"))
    rs, ri = jsharded.sharded_ivf_search(mesh, built, q, k=K)
    ours, meta = tsharded.load_ivf_sharded(str(tmp_path / "ivf"), with_meta=True, device="cpu")
    assert meta["n_shards"] == 8 and meta["bucket_dtype"] == dtype
    assert tivf.DTYPE_NAMES[ours.buckets.dtype] == dtype and ours.nprobe == 6
    assert ours.tail.shape[0] == np.asarray(built.tail).shape[0]
    s, i = tsharded.sharded_ivf_search(CPU1, ours, q, k=K)
    assert_search_equal(s, i, rs, ri, dtype)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_port_sharded_dir_loads_in_jax(persist_store, tmp_path, dtype, n_dev):
    """The port's save_ivf_sharded -> JAX's load_ivf_sharded on a 1-, 2- and
    8-device mesh: JAX answers as the port does."""
    store, _, q = persist_store
    ours = tsharded.build_ivf_from_store(CPU1, store, nlist=32, nprobe=6, slack=1.3, seed=5,
                                         dtype=dtype, chunk_rows=512)
    out = str(tmp_path / "ivf")
    tsharded.save_ivf_sharded(ours, out)
    with open(f"{out}/ivf_sharded_meta.json") as f:
        meta = json.load(f)
    assert meta["bucket_dtype"] == dtype and meta["n_shards"] == 1
    assert meta["corpus_rows"] == 3000
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    back = jsharded.load_ivf_sharded(mesh, out)
    rs, ri = jsharded.sharded_ivf_search(mesh, back, q, k=K)
    s, i = tsharded.sharded_ivf_search(CPU1, ours, q, k=K)
    assert_search_equal(s, i, rs, ri, f"{dtype} on {n_dev}")
    again = tsharded.load_ivf_sharded(out, device="cpu")
    for name in tivf.ARRAYS + tivf.SIDECARS:
        a, b = getattr(again, name), getattr(ours, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name


def test_sharded_files_are_jax_bytes(persist_store, tmp_path):
    """The port's save of a JAX-built index writes JAX's one-shard files
    byte for byte (the bfloat16 .npy header included) and JAX's meta."""
    store, _, _ = persist_store
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    for dtype in ("bfloat16", "int8"):
        built = jsharded.build_ivf_from_store(mesh1, store, nlist=32, nprobe=6, slack=1.3,
                                              seed=5, dtype=dtype, chunk_rows=512)
        jdir, tdir = tmp_path / f"jax_{dtype}", tmp_path / f"port_{dtype}"
        jsharded.save_ivf_sharded(built, str(jdir))
        tsharded.save_ivf_sharded(tivf.ivf_index_from_jax(built, "cpu"), str(tdir))
        names = sorted(p.name for p in jdir.iterdir())
        assert names == sorted(p.name for p in tdir.iterdir())
        for name in names:
            if name.endswith(".json"):
                assert json.loads((jdir / name).read_text()) == json.loads(
                    (tdir / name).read_text())
            else:
                assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_ivf_round_trips_across_packages(rng, tmp_path, direction):
    """save_ivf / load_ivf in both directions, bfloat16 and int8, with the
    stale sidecars of an int8 save removed by a float save over it."""
    x = _mixture(rng, 800, 16)
    q = _mixture(rng, 3, 16)
    jb = jivf.build_ivf(x, nlist=8, nprobe=4, dtype="bfloat16")
    for jidx in (jb, jivf.quantize_ivf(jivf.build_ivf(x, nlist=8, nprobe=4))):
        d = str(tmp_path / ("i8" if jidx.scale is not None else "bf16"))
        tidx = tivf.ivf_index_from_jax(jidx, "cpu")
        if direction == "port_to_jax":
            tivf.save_ivf(tidx, d)
            back = jivf.load_ivf(d)
            assert back.buckets.dtype == jidx.buckets.dtype and back.nprobe == jidx.nprobe
            s1, i1 = jivf.ivf_search(jidx, q, k=5)
            s2, i2 = jivf.ivf_search(back, q, k=5)
        else:
            jivf.save_ivf(jidx, d)
            back = tivf.load_ivf(d, device="cpu")
            assert back.buckets.dtype == tidx.buckets.dtype and back.nprobe == jidx.nprobe
            s1, i1 = tivf.ivf_search(tidx, q, k=5)
            s2, i2 = tivf.ivf_search(back, q, k=5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(s1, s2)
    d = str(tmp_path / "stale")
    if direction == "port_to_jax":
        jivf.save_ivf(jivf.quantize_ivf(jb), d)
        tivf.save_ivf(tivf.ivf_index_from_jax(jb, "cpu"), d)
        back = jivf.load_ivf(d)
    else:
        tivf.save_ivf(tivf.quantize_ivf(tivf.ivf_index_from_jax(jb, "cpu")), d)
        jivf.save_ivf(jb, d)
        back = tivf.load_ivf(d, device="cpu")
    assert back.scale is None and back.means is None and back.tail_scale is None
    assert str(back.buckets.dtype).endswith("bfloat16")


# ---------------------------------------------------------------------------
# Retriever(ivf=True) and the capacity tier
# ---------------------------------------------------------------------------

QUESTIONS = [
    ("what is the capital of france", [("who wrote hamlet", "shakespeare")]),
    ("and its population", [("capital of france", "paris")]),
    ("tell me about rivers", []),
    ("which one is longest", [("tell me about rivers", "the nile and amazon")]),
]


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    from haconvdr_tpu.config import DataConfig, ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.utils.testing import HashTokenizer

    cfg = ModelConfig.tiny(vocab_size=512)
    rng = np.random.RandomState(5)
    x = _mixture(rng, 600, cfg.embedding_dim, n_modes=12) * 4.0
    root = tmp_path_factory.mktemp("ivf_serve")
    return dict(
        tok=HashTokenizer(cfg.vocab_size), cfg=cfg, params=init_params_numpy(cfg, seed=11),
        x=x, store=_write_store(root / "emb", x), root=root,
        offset2pid=[1000 + 3 * i for i in range(len(x))],
        data_cfg=DataConfig(is_train=False, use_PRL=False, max_query_length=12,
                            max_doc_length=16, max_response_length=8, max_concat_length=32),
    )


def _retrievers(serving, which=("jax", "port"), store=None, **kw):
    from haconvdr_tpu.config import SearchConfig
    from haconvdr_tpu.serve import Retriever as JaxRetriever
    from haconvdr_torch.serve import Retriever

    base = dict(offset2pid=serving["offset2pid"], data_cfg=serving["data_cfg"])
    kw.setdefault("search_cfg", SearchConfig(top_k=8, per_device_test_batch_size=2))
    args = (serving["tok"], serving["params"], serving["cfg"],
            serving["store"] if store is None else store)
    out = []
    for w in which:
        if w == "jax":
            out.append(JaxRetriever(*args, **base, **kw))
        else:
            out.append(Retriever(*args, **base, **kw, device="cpu"))
    return out


def _same_hits(ours, ref, what=""):
    s = np.array([[x for _, x in ours]])
    rs = np.array([[x for _, x in ref]])
    assert_search_equal(s, np.array([[p for p, _ in ours]]), rs,
                        np.array([[p for p, _ in ref]]), what)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16", "int8"])
def test_ivf_retriever_matches_jax_at_full_probe(serving, store_dtype, request):
    """Retriever(ivf=True) in both packages with nlist 16 (a multiple of the
    JAX mesh's 8 shards, so both build 16 clusters) probing everything:
    the same pids and scores; the float ones equal the port's flat index.
    int8 codes are residuals of the cluster means, so there the port takes
    JAX's k-means init rows (the float answers do not depend on them)."""
    if store_dtype == "int8":
        request.getfixturevalue("shared_init")
    kw = dict(ivf=True, ivf_nlist=16, ivf_nprobe=16, store_dtype=store_dtype)
    jr, tr = _retrievers(serving, **kw)
    assert tr.ivf_index is not None and tr.index is None
    assert tr.ivf_index.centroids.shape[0] == 16 and tr.ivf_index.nprobe == 16
    (flat,) = _retrievers(serving, ("port",), store_dtype=store_dtype)
    for question, history in QUESTIONS:
        ours = tr.retrieve(question, history)
        assert len(ours) == 8
        _same_hits(ours, jr.retrieve(question, history), store_dtype)
        if store_dtype != "int8":  # the flat int8 index scores int8 x int8 at k <= 128
            _same_hits(ours, flat.retrieve(question, history), "flat " + store_dtype)


def test_ivf_retriever_reloads_across_packages(serving, tmp_path):
    """At partial probe: the port's Retriever reloads a JAX-built ivf_dir
    (8 shards) and answers as JAX's; JAX's reloads the port's."""
    kw = dict(ivf=True, ivf_nlist=16, ivf_nprobe=4, store_dtype="bfloat16")
    (jr,) = _retrievers(serving, ("jax",), ivf_dir=str(tmp_path / "jax"), **kw)
    (tr,) = _retrievers(serving, ("port",), ivf_dir=str(tmp_path / "jax"), **kw)
    assert tr.ivf_index.nprobe == 4 and tr.ivf_index.buckets.dtype == torch.bfloat16
    (built,) = _retrievers(serving, ("port",), ivf_dir=str(tmp_path / "port"), **kw)
    (jr2,) = _retrievers(serving, ("jax",), ivf_dir=str(tmp_path / "port"), **kw)
    # the persisted nprobe is the default of a restart with ivf_nprobe=None
    (again,) = _retrievers(serving, ("port",), ivf=True, ivf_nlist=16, store_dtype="bfloat16",
                           ivf_dir=str(tmp_path / "port"))
    assert again.ivf_index.nprobe == 4
    for question, history in QUESTIONS:
        _same_hits(tr.retrieve(question, history), jr.retrieve(question, history), "port<-jax")
        ours = built.retrieve(question, history)
        _same_hits(jr2.retrieve(question, history), ours, "jax<-port")
        assert again.retrieve(question, history) == ours


def test_capacity_tier_composition(serving, tmp_path):
    """tests/test_rescore.py:165-245 on the port: residual-int8 IVF probing
    everything, the exact rescore from the float store (oversample 5), the
    ivf_dir save and reload, behind BatchingRetriever: the flat float32
    oracle's answers."""
    from haconvdr_tpu.config import SearchConfig
    from haconvdr_torch.serve import BatchingRetriever

    k = 5
    (oracle,) = _retrievers(serving, ("port",), store_dtype="float32",
                            search_cfg=SearchConfig(top_k=k, per_device_test_batch_size=1))
    tier = dict(
        search_cfg=SearchConfig(top_k=k, per_device_test_batch_size=1, rescore_oversample=5.0),
        ivf=True, store_dtype="int8", ivf_nlist=16, ivf_nprobe=10**6,
        ivf_dir=str(tmp_path / "ivf"),
    )
    for restart in (False, True):
        (tr,) = _retrievers(serving, ("port",), **tier)
        assert tr.ivf_index.means is not None and tr.ivf_index.buckets.dtype == torch.int8
        with BatchingRetriever(tr, max_batch=4, max_wait_ms=20.0) as batcher:
            futs = [batcher.submit(q, h) for q, h in QUESTIONS * 2]
            got = [f.result(timeout=120) for f in futs]
        for (q, h), g in zip(QUESTIONS * 2, got):
            want = oracle.retrieve(q, h)
            assert [p for p, _ in g] == [p for p, _ in want], restart
            np.testing.assert_allclose([s for _, s in g], [s for _, s in want], rtol=1e-5,
                                       atol=1e-5)
    assert (tmp_path / "ivf" / "ivf_sharded_meta.json").exists()


def test_ivf_reload_staleness_guards(serving, tmp_path):
    kw = dict(ivf=True, ivf_nlist=16, ivf_nprobe=4, ivf_dir=str(tmp_path / "ivf"))
    _retrievers(serving, ("port",), store_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="holds bfloat16 buckets"):
        _retrievers(serving, ("port",), store_dtype="int8", **kw)
    fewer = _write_store(tmp_path / "fewer", serving["x"][:590])
    with pytest.raises(ValueError, match="stale"):
        _retrievers(serving, ("port",), store=fewer, store_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="EmbeddingBlockStore"):
        _retrievers(serving, ("port",), store=torch.from_numpy(serving["x"]), ivf=True)


def test_batching_retriever_warns_over_ivf(serving, caplog):
    from haconvdr_torch.serve import BatchingRetriever

    (tr,) = _retrievers(serving, ("port",), ivf=True, ivf_nlist=16)
    assert tr.ivf_index.nprobe == 16  # the default 32 >= nlist probes all
    for max_batch, warned in ((16, False), (64, True)):
        caplog.clear()
        with caplog.at_level("WARNING", logger="haconvdr_torch.serve"):
            BatchingRetriever(tr, max_batch=max_batch).close()
        assert any("IVF" in r.message for r in caplog.records) == warned


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_build_ivf_cli_matches_jax(rng, tmp_path, capsys):
    from haconvdr_tpu.cli.build_ivf import main as jax_main
    from haconvdr_torch.cli.build_ivf import main as port_main

    x = _mixture(rng, 2500, 16, n_modes=8)
    q = _mixture(rng, 4, 16, n_modes=8)
    _write_store(tmp_path / "store", x)
    common = [f"embeddings={tmp_path / 'store'}", "nlist=8", "nprobe=8", "dtype=bfloat16",
              "chunk_rows=512", "train_rows=2500"]
    jax_main(common + [f"out={tmp_path / 'jax'}"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_main(common + [f"out={tmp_path / 'port'}", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(ref)
    for key in ("nlist", "capacity", "dim", "dtype"):
        assert got[key] == ref[key], key
    assert got["dtype"] == "bfloat16" and got["n_shards"] == 1
    idx = tsharded.load_ivf_sharded(str(tmp_path / "port"), device="cpu")
    s, i = tsharded.sharded_ivf_search(CPU1, idx, q, k=5)
    xr = torch.from_numpy(x).bfloat16().float().numpy()
    qr = torch.from_numpy(q).bfloat16().float().numpy()
    assert_search_equal(s, i, *_exact(qr, xr, 5), "full probe")
    mesh = make_mesh()
    back = jsharded.load_ivf_sharded(mesh, str(tmp_path / "port"))
    rs, ri = jsharded.sharded_ivf_search(mesh, back, q, k=5)
    assert_search_equal(s, i, rs, ri, "jax load")


def test_ivf_sweep_cli_matches_jax(rng, tmp_path, capsys):
    """The sweep CLIs on the same files: the same row keys, recall 1.0 at
    full probe in both, a smaller probe never above it."""
    from haconvdr_tpu.cli.ivf_sweep import main as jax_main
    from haconvdr_torch.cli.ivf_sweep import main as port_main

    x = _mixture(rng, 2000, 16, n_modes=16)
    q = _mixture(rng, 32, 16, n_modes=16)
    np.save(tmp_path / "emb.npy", x)
    np.save(tmp_path / "q.npy", q)
    common = [f"embeddings={tmp_path / 'emb.npy'}", f"queries={tmp_path / 'q.npy'}",
              "nlist=16", "nprobe=2,16", "slack=1.3", "k=10", "dtype=float32"]
    jax_main(common + [f"out={tmp_path / 'jax.jsonl'}"])
    port_main(common + [f"out={tmp_path / 'port.jsonl'}", "--device", "cpu"])
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best"]
    ref = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    got = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    assert [list(r) for r in got] == [list(r) for r in ref]
    by_probe = {r["nprobe"]: r for r in got}
    assert by_probe[16]["recall_at_k"] == 1.0 == {r["nprobe"]: r for r in ref}[16]["recall_at_k"]
    assert by_probe[2]["recall_at_k"] <= 1.0 and best["nprobe"] == 16
    for r in got:
        assert r["latency_ms_per_query"] > 0 and r["memory_overhead"] >= 1.0


def test_ivf_sweep_int8_oversample_and_overflow(rng):
    """int8 sweeps quantized buckets (bf16 build, then quantize_ivf) with the
    two-stage column, clamped to the pool; a lumpy corpus records JAX's
    overflow row and the sweep goes on."""
    from haconvdr_tpu.cli.ivf_sweep import sweep as jax_sweep
    from haconvdr_torch.cli.ivf_sweep import sweep

    x = _mixture(rng, 2000, 16, n_modes=16)
    q = _mixture(rng, 32, 16, n_modes=16)
    kw = dict(nlists=[16], nprobes=[1, 16], slacks=[1.3], k=10, dtype="int8",
              rescore_oversample=50.0)
    rows = sweep(x, q, device="cpu", **kw)
    ref = jax_sweep(x, q, **{**kw, "nprobes": [16]})
    assert [list(r) for r in rows[1:]] == [list(r) for r in ref]
    full = rows[1]
    assert full["dtype"] == "int8" and full["recall_at_k"] >= 0.9
    assert full["recall_two_stage"] >= full["recall_at_k"] and rows[0]["recall_two_stage"] > 0
    lumpy = _mixture(rng, 512, 16, n_modes=2, spread=0.01)
    lumpy[:504] = lumpy[0]
    rows = sweep(lumpy, lumpy[:16], [8], [8], [1.05, 64.0], k=5, device="cpu")
    ref = jax_sweep(lumpy, lumpy[:16], [8], [8], [1.05, 64.0], k=5)
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
    assert "error" in rows[0] and rows[0]["slack"] == 1.05 and "IVF overflow" in rows[0]["error"]
    assert rows[1]["slack"] == 64.0 and rows[1]["recall_at_k"] >= 0.99


def test_ivf_geometry_check_cli(tmp_path):
    """The geometry harness at a tiny config: trains the port's tower, embeds
    2,000 passages, emits JAX's geometry row and sweep rows; full probe
    recalls 1.0; the same arguments give the same rows (torch generators)."""
    from haconvdr_torch.cli.ivf_geometry_check import main as geo_main

    argv = ["n=2000", "steps=4", "warmup=2", "n_topics=8", "layers=2", "hidden=64",
            "heads=2", "intermediate=128", "vocab=512", "p_len=16", "q_len=8",
            "n_queries=32", "batch=16", "nlist=8", "nprobe=2,8", "slack=2.0", "k=10",
            "dtype=float32", "--device", "cpu"]
    rows = geo_main(argv + [f"out={tmp_path / 'geo.jsonl'}"])
    geo = rows[0]
    assert list(geo) == ["metric", "n_sampled", "effective_rank", "mean_cos_to_centroid",
                         "norm_cv", "train_steps"]
    assert geo["metric"] == "geometry" and geo["train_steps"] == 4
    assert 1.0 <= geo["effective_rank"] <= 768.0 and -1.0 <= geo["mean_cos_to_centroid"] <= 1.0
    by_probe = {r["nprobe"]: r for r in rows[1:]}
    assert by_probe[8]["recall_at_k"] == 1.0 >= by_probe[2]["recall_at_k"]
    assert [json.loads(line) for line in open(tmp_path / "geo.jsonl")] == rows
    again = geo_main(argv + [f"out={tmp_path / 'again.jsonl'}"])
    strip = [{k: v for k, v in r.items() if k not in ("latency_ms_per_query", "build_s")}
             for r in rows]
    assert [{k: v for k, v in r.items() if k not in ("latency_ms_per_query", "build_s")}
            for r in again] == strip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_npy_files_match_numpy(rng, tmp_path, dtype):
    """utils.io writes a tensor as np.save writes the same array (bfloat16
    as ml_dtypes' raw '<V2' records, byte for byte), reads np.save's file
    back to the same bits, and ivf_sweep's loader widens it to float32."""
    import ml_dtypes

    from haconvdr_torch.cli.ivf_sweep import _load_embeddings
    from haconvdr_torch.utils.io import load_npy, save_npy

    x = rng.randn(37, 8).astype(np.float32)
    ref = (x * 40).astype(np.int8) if dtype == "int8" else x.astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    np.save(tmp_path / "ref.npy", ref)
    t = load_npy(str(tmp_path / "ref.npy"), torch.device("cpu"))
    assert t.dtype == getattr(torch, dtype)
    save_npy(str(tmp_path / "port.npy"), t)
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "ref.npy").read_bytes()
    if dtype != "int8":
        np.testing.assert_array_equal(_load_embeddings(str(tmp_path / "port.npy")),
                                      ref.astype(np.float32))
