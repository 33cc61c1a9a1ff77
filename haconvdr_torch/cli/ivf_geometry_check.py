"""CLI: IVF recall on a trained encoder's geometry, with no external data
(counterpart of haconvdr_tpu/cli/ivf_geometry_check.py), on one device.

  1. topic-structured token streams (each passage blends the token bands
     of one or two of ``n_topics`` topics; queries are short single-topic
     strings), drawn from ``torch.Generator``s on the device;
  2. the ANCE tower trained from random init for ``steps`` in-batch
     contrastive steps plus an auxiliary topic-classification head
     (``train_encoder``): masked-mean pooling, batch-centred embeddings,
     scores scaled by 1/sqrt(d), AdamW with a linear warmup;
  3. ``n`` passages and ``n_queries`` queries embedded with the trained
     tower (bfloat16-rounded, as the JAX harness keeps them);
  4. the IVF sweep of ``cli/ivf_sweep.sweep`` on those embeddings.

Prints (or writes to ``out=``) one ``geometry`` row (effective rank, mean
cosine to the centroid, norm spread) and one row per (nlist, slack,
nprobe), with the JAX harness's keys.  Its token streams come from torch
generators, so its numbers are its own, not the JAX harness's.

    python -m haconvdr_torch.cli.ivf_geometry_check \
        n=1000000 steps=600 n_topics=2000 nlist=1024,4096 \
        nprobe=8,16,32,64,128 out=geometry_sweep.jsonl [--device cuda|cpu]
"""

from __future__ import annotations

import json
import logging
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from haconvdr_torch.cli._args import pop_device
from haconvdr_torch.cli.ivf_sweep import sweep
from haconvdr_torch.config import ModelConfig
from haconvdr_torch.device import resolve_device
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.train.trainer import AdamWState, ClipAdamW
from haconvdr_torch.utils.io import parse_kv_args

logger = logging.getLogger(__name__)


def make_topic_batch(g: torch.Generator, batch, length, n_topics, vocab, topics=None):
    """([batch, length] token ids, [batch] topics) on ``g``'s device: each
    token comes from the passage's topic band with p 0.7, a second topic's
    with p 0.2 and the whole vocabulary with p 0.1; a band is ``max(64,
    vocab // 64)`` ids."""
    dev = g.device
    band = max(64, vocab // 64)
    if topics is None:
        topics = torch.randint(0, n_topics, (batch,), generator=g, device=dev)
    second = torch.randint(0, n_topics, (batch,), generator=g, device=dev)

    def center(t):
        return (t.to(torch.float32) / n_topics * (vocab - band - 4)).to(torch.int64) + 4

    off = torch.randint(0, band, (batch, length), generator=g, device=dev)
    gtok = torch.randint(4, vocab, (batch, length), generator=g, device=dev)
    mix = torch.rand((batch, length), generator=g, device=dev)
    ids = torch.where(
        mix < 0.7, center(topics)[:, None] + off,
        torch.where(mix < 0.9, center(second)[:, None] + off, gtok),
    )
    return ids.clamp(4, vocab - 1), topics


class _Towers(nn.Module):
    """The trained tower and its topic head, updated as one parameter set."""

    def __init__(self, enc: AnceEncoder, w_cls: torch.Tensor):
        super().__init__()
        self.enc = enc
        self.w_cls = nn.Parameter(w_cls)


def warmup_constant(lr: float, warmup: int):
    """``optax.join_schedules([linear_schedule(0, lr, warmup),
    constant_schedule(lr)], [warmup])``: lr * c / warmup, then lr."""
    warmup = max(warmup, 1)

    def schedule(count: int) -> np.float32:
        if count < warmup:
            return np.float32(lr) * (np.float32(count) / np.float32(warmup))
        return np.float32(lr)

    return schedule


def train_encoder(cfg: ModelConfig, steps, batch, q_len, p_len, n_topics, lr=1e-4, wd=0.0,
                  warmup=100, seed=0, device=None):
    """``steps`` in-batch CE steps of one tower for queries and passages
    (haconvdr_tpu/cli/ivf_geometry_check.py:80-211): no dropout, masked-mean
    pooling, both losses on batch-centred embeddings, the contrastive scores
    scaled by 1/sqrt(d).  The first half trains the topic head alone (pure
    contrastive training from random init stalls at its collapsed point),
    the second both.  AdamW (b1 0.9, b2 0.999, eps 1e-8, ``wd`` on every
    parameter, no clip) on the warmup schedule.  Returns (tower, the
    contrastive losses every 25 steps)."""
    dev = resolve_device(device)
    enc = AnceEncoder.from_jax_params(init_params_numpy(cfg, seed), cfg, dev)
    g0 = torch.Generator(device=dev).manual_seed(17 + seed)
    w_cls = torch.randn(cfg.embedding_dim, n_topics, generator=g0, device=dev) * 0.02
    model = _Towers(enc, w_cls)
    opt = ClipAdamW(warmup_constant(lr, warmup), float("inf"), 1e-8, wd)
    state = opt.init(model)
    state = AdamWState(state.mu, state.nu, {n: True for n in state.decay})
    inv_temp = 1.0 / float(np.sqrt(cfg.embedding_dim))
    named = list(model.named_parameters())
    losses = []
    for s in range(steps):
        g = torch.Generator(device=dev).manual_seed(1000 + s)
        pids, topics = make_topic_batch(g, batch, p_len, n_topics, cfg.vocab_size)
        qids, _ = make_topic_batch(g, batch, q_len, n_topics, cfg.vocab_size, topics=topics)
        q = enc(qids, torch.ones_like(qids), use_mean=True, trainable=True)
        p = enc(pids, torch.ones_like(pids), use_mean=True, trainable=True)
        q = q - q.mean(dim=0, keepdim=True)
        p = p - p.mean(dim=0, keepdim=True)
        contrastive = F.cross_entropy((q @ p.T) * inv_temp, torch.arange(batch, device=dev))
        w = model.w_cls.to(q.dtype)
        cls = 0.5 * (F.cross_entropy(q @ w, topics) + F.cross_entropy(p @ w, topics))
        loss = (0.0 if s < steps // 2 else 1.0) * contrastive + cls
        grads = torch.autograd.grad(loss, [t for _, t in named])
        opt.apply_(model, {n: gr for (n, _), gr in zip(named, grads)}, state)
        if s % 25 == 0 or s == steps - 1:
            c = float(contrastive.detach())
            losses.append(c)
            logger.info("train step %d loss %.4f (contrastive %.4f)", s, float(loss.detach()), c)
    return enc.eval(), losses


@torch.no_grad()
def embed_corpus(enc: AnceEncoder, n, length, n_topics, batch=512, q_len=0):
    """[n, embedding_dim] float32 host embeddings of ``n`` topic passages
    (queries with ``q_len`` > 0), rounded to bfloat16 as the JAX harness
    keeps them."""
    dev = next(enc.parameters()).device
    g = torch.Generator(device=dev).manual_seed(7 if q_len else 3)
    L = q_len or length
    parts = []
    for _ in range(-(-n // batch)):
        ids, _ = make_topic_batch(g, batch, L, n_topics, enc.cfg.vocab_size)
        e = enc(ids, torch.ones_like(ids), use_mean=True,
                host_mask=np.ones(tuple(ids.shape), np.int32))
        parts.append(e.to(torch.bfloat16).to(torch.float32).cpu().numpy())
    return np.concatenate(parts)[:n]


def geometry_stats(emb: np.ndarray, sample: int = 100_000) -> dict:
    """Effective rank and cone concentration of a strided sample."""
    x = emb[:: max(1, len(emb) // sample)]
    mu = x.mean(axis=0)
    s = np.linalg.svd(x - mu, compute_uv=False)
    p = (s**2) / (s**2).sum()
    eff_rank = float(np.exp(-(p * np.log(np.maximum(p, 1e-12))).sum()))
    norms = np.linalg.norm(x, axis=1)
    cos_mu = (x @ mu) / (np.maximum(norms, 1e-9) * max(np.linalg.norm(mu), 1e-9))
    return {
        "metric": "geometry",
        "n_sampled": int(len(x)),
        "effective_rank": round(eff_rank, 1),
        "mean_cos_to_centroid": round(float(cos_mu.mean()), 4),
        "norm_cv": round(float(norms.std() / norms.mean()), 4),
    }


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device, argv = pop_device(argv)
    dev = resolve_device(device)  # raises without the card before any work
    args = parse_kv_args(argv)
    n = int(args.get("n", "1000000"))
    steps = int(args.get("steps", "600"))
    n_topics = int(args.get("n_topics", "2000"))
    p_len = int(args.get("p_len", "192"))
    q_len = int(args.get("q_len", "32"))
    n_queries = int(args.get("n_queries", "2048"))
    batch = int(args.get("batch", "128"))
    nlists = [int(x) for x in args.get("nlist", "1024,4096").split(",")]
    nprobes = [int(x) for x in args.get("nprobe", "8,16,32,64,128").split(",")]
    slacks = [float(x) for x in args.get("slack", "1.3").split(",")]
    k = int(args.get("k", "100"))
    out_path = args.get("out", "")
    remat_arg = args.get("remat", "mlp")
    cfg = ModelConfig(
        dtype=args.get("dtype", "bfloat16"),
        remat={"0": False, "1": True}.get(remat_arg, remat_arg),
        num_hidden_layers=int(args.get("layers", "12")),
        hidden_size=int(args.get("hidden", "768")),
        num_attention_heads=int(args.get("heads", "12")),
        intermediate_size=int(args.get("intermediate", "3072")),
        vocab_size=int(args.get("vocab", "50265")),
    )
    t0 = time.time()
    enc, losses = train_encoder(
        cfg, steps, batch, q_len, p_len, n_topics, lr=float(args.get("lr", "1e-4")),
        wd=float(args.get("wd", "0.0")), warmup=int(args.get("warmup", "100")), device=dev,
    )
    logger.info("trained %d steps in %.0f s (losses %s)", steps, time.time() - t0, losses)
    t0 = time.time()
    emb = embed_corpus(enc, n, p_len, n_topics)
    logger.info("embedded %d passages in %.0f s", n, time.time() - t0)
    queries = embed_corpus(enc, n_queries, p_len, n_topics, q_len=q_len)
    if args.get("save_emb"):  # reusable by cli/ivf_sweep.py (embeddings=/queries=)
        np.save(args["save_emb"], emb)
        np.save(args["save_emb"].replace(".npy", "") + "_queries.npy", queries)
        logger.info("saved embeddings to %s", args["save_emb"])

    rows = [geometry_stats(emb)]
    rows[0]["train_steps"] = steps
    rows += sweep(emb, queries, nlists, nprobes, slacks, k=k, device=dev)
    out = open(out_path, "w") if out_path else sys.stdout
    for r in rows:
        print(json.dumps(r), file=out, flush=True)
    if out_path:
        out.close()
    return rows


if __name__ == "__main__":
    main()
