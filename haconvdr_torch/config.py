"""Unified configuration system.

The reference mixes two config styles: TOML -> argparse.Namespace
(the reference's gen_tokenized_doc.py:352-368, Config/*.toml) and plain
argparse (its src/train_HAConvDR_topiocqa.py:210-250).  Here a
single dataclass hierarchy covers every knob; each CLI loads a TOML file
and/or command-line overrides into the relevant dataclass.

The reference's ``type=bool`` argparse footgun (any non-empty string is
True, src/train_HAConvDR_topiocqa.py:227-231) is deliberately not
reproduced: booleans parse "true/false/1/0/yes/no" strictly.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

try:  # python >= 3.11
    import tomllib as _toml

    def _load_toml(path: str) -> Dict[str, Any]:
        with open(path, "rb") as f:
            return _toml.load(f)

except ImportError:  # pragma: no cover
    import toml as _toml_pkg

    def _load_toml(path: str) -> Dict[str, Any]:
        return _toml_pkg.load(path)


def parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


@dataclass
class SequenceConfig:
    """Token-length knobs shared by data builders and models.

    Defaults follow the TopiOCQA training setup
    (src/train_HAConvDR_topiocqa.py:218-242, README.md:59-74).
    """

    max_query_length: int = 32
    max_doc_length: int = 384
    max_response_length: int = 64
    max_concat_length: int = 512


@dataclass
class DataConfig(SequenceConfig):
    dataset: str = "topiocqa"  # topiocqa | qrecc | cast
    train_file_path: str = ""
    test_file_path: str = ""
    collection_path: str = ""
    is_train: bool = True
    use_PRL: bool = True
    is_PRF: bool = False
    PRF_top: int = 1
    # query construction mode: raw | rewrite | convq | convqa | convqp
    mode: str = "convqp"
    hard_neg_type: str = "bm25"  # bm25 | prepos | none
    # >1 trains against that many BM25 negatives per example
    # (Retrieval_qrecc_negs, src/data.py:745-818); qrecc only
    num_negs: int = 1
    seed: int = 42


@dataclass
class ModelConfig:
    model_type: str = "ANCE"  # ANCE (roberta) | BERT
    pretrained_encoder_path: str = ""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 50265
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    embedding_dim: int = 768  # output of the ANCE head
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # compute dtype of the tower's products ("float32" | "bfloat16");
    # params stay float32.  A bfloat16 int8 tower runs the fused
    # LayerNorm-quant and MLP kernels (csrc/fused_ln.cu, csrc/fused_mlp.cu);
    # bfloat16 attention runs the tensor-core route of
    # csrc/attention_tc.cuh, float32 the 3xTF32 route.
    dtype: str = "float32"
    # the JAX package's switch for its fused attention kernel.  The port
    # reads it from TOML files and overrides and does not consult it: a
    # CUDA tensor always takes the attention kernels (csrc/
    # fused_attention.cu for inference, csrc/flash_attention.cu for a
    # trainable tower or under dropout), a CPU tensor their plain twins.
    use_flash_attention: bool = True
    # residual + LayerNorm + per-token int8 codes in one kernel
    # (ops/fused_ln.fused_residual_ln_quant, csrc/fused_ln.cu): each
    # LayerNorm output and the codes the next int8 dense takes.  Used by
    # int8 towers with a bfloat16 carry, in eval mode; float towers and
    # float32 carries take the plain LayerNorm.
    use_fused_ln: bool = True
    # the whole int8 MLP block (dense -> gelu -> requantize -> dense ->
    # residual -> LayerNorm -> codes) in csrc/fused_mlp.cu
    # (ops/fused_mlp.fused_mlp_block).  Same gates as use_fused_ln, and
    # needs it.
    use_fused_mlp: bool = True
    # recomputation in the backward pass (torch.utils.checkpoint):
    #   True  — checkpoint each transformer layer, so only its input is
    #           saved;
    #   "mlp" — checkpoint only the MLP block: the flash-attention kernels
    #           save nothing [L, L]-shaped, so this drops the [B, L, 4H]
    #           MLP intermediates and re-runs two dense products;
    #   False — save everything (small models, ample device memory).
    remat: "bool | str" = False

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """Small config for tests."""
        base = dict(
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=64,
            vocab_size=128,
            max_position_embeddings=66,
            embedding_dim=16,
            hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
        )
        base.update(kw)
        return cls(**base)


@dataclass
class TrainConfig:
    num_train_epochs: int = 10
    per_device_train_batch_size: int = 64
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    num_warmup_portion: float = 0.1
    max_grad_norm: float = 1.0
    accumulation_steps: int = 8
    print_steps: int = 64
    alpha: float = 1.0  # pseudo-prepos weight (src/train_HAConvDR_topiocqa.py:66)
    is_pseudo_prepos: bool = False
    is_prepos_neg: bool = True
    # compute dtype of the FROZEN passage towers only ("" = the model's
    # dtype).  They carry no gradients, so "bfloat16" runs them on the
    # tensor-core attention route with a bfloat16 carry, and "int8"
    # quantizes them once into int8 towers (the fused LayerNorm-quant and
    # MLP kernels with a bfloat16 carry), while the trained query tower
    # keeps float32 gradients.  "" keeps the all-float32 reference
    # semantics.
    frozen_dtype: str = ""
    model_output_path: str = "output/model"
    seed: int = 42


@dataclass
class IndexConfig:
    raw_collection_path: str = ""
    data_output_path: str = ""
    tokenized_dir: str = ""
    max_seq_length: int = 384
    max_doc_character: int = 10000
    per_device_eval_batch_size: int = 256
    num_tokenize_workers: int = 8
    per_block_passage_num: int = 2_500_000
    # embedding storage dtype: float32 | bfloat16 (half the bytes per
    # passage) | int8 (a quarter; per-block scalar scales,
    # index/quantize.py)
    store_dtype: str = "float32"
    # int8-quantize the encoder's dense kernels for corpus encoding
    # (models/encoder.py:quantize_encoder_params): the six dense products
    # of a layer run int8 x int8 with per-token activation codes;
    # embeddings, LayerNorms and the head stay float32.  An
    # inference-only approximation: embeddings move slightly.
    compute_int8: bool = False


@dataclass
class SearchConfig:
    passage_embeddings_dir_path: str = ""
    passage_offset2pid_path: str = ""
    passage_block_num: int = -1  # -1: read blocks until they run out
    top_k: int = 100
    rel_threshold: int = 1
    per_device_test_batch_size: int = 64
    test_type: str = "convqp"
    qrel_output_path: str = "output"
    output_trec_file: str = "res.trec"
    trec_gold_qrel_file_path: str = ""
    query_chunk: int = 256  # queries per search dispatch
    passage_chunk: int = 131072  # passage tile per scan step
    # the JAX package's kernel switch; the port reads it and does not
    # consult it: a CUDA tensor always takes the search kernels (v4, v3
    # fused top-k), a CPU tensor their plain twins
    use_pallas: bool = True
    # >0: streaming searches copy incoming blocks into one
    # device-resident [superblock_rows, D] buffer and search each filled
    # buffer once, as a resident index (ops/topk.py BlockSearcher
    # superblock_rows; rows past the fill are masked by n_valid).  0
    # keeps the per-block seeded strategy.
    superblock_rows: int = 0
    # "int8": the super-block buffer itself stays int8, holding four
    # times the rows of a float32 one, and each filled buffer searches
    # through the v4 search's int8 x int8 mode; incoming blocks
    # requantize to the store's global_scale().  "" = the buffer holds
    # the float compute dtype (int8 blocks dequantized on insert).
    superblock_dtype: str = ""
    # >1: two-stage serving: the first stage (typically int8-resident)
    # retrieves ceil(top_k * rescore_oversample) candidates, and their
    # exact rows are re-scored from the float disk store on the host
    # (index/rescore.py).  0/1 = off.
    rescore_oversample: float = 0.0


@dataclass
class BM25Config:
    """BM25 knobs (Config/bm25_topiocqa.toml:6-7, bm25_qrecc.toml:5-6)."""

    k1: float = 0.9
    b: float = 0.4
    top_k: int = 100
    index_dir_path: str = ""
    num_threads: int = 8


@dataclass
class ServeConfig:
    """Online serving daemon (serve_http.RetrievalServer over
    serve.BatchingRetriever) — beyond-reference surface: the reference has
    no serving layer at all (retrieval exists only as batch eval scripts,
    src/test_HAConvDR_topiocqa.py)."""

    host: str = "127.0.0.1"
    port: int = 8080
    # coalescing window: the worker dispatches when max_batch requests are
    # queued or the oldest has waited max_wait_ms (serve.BatchingRetriever)
    max_batch: int = 64
    max_wait_ms: float = 2.0
    # backpressure: bound on queued-but-undispatched requests (beyond it
    # submits get 503 + Retry-After) and the per-request answer deadline
    # (504 past it — a stalled dispatch must not pin request threads)
    queue_depth: int = 1024
    request_timeout_s: float = 30.0
    # index residency (serve.Retriever): resident=True copies the store
    # onto the card as one flat index (ShardedIndex, searched by the v4
    # kernels); resident=False streams its blocks through BlockSearcher
    # per search (first block v4, later blocks the seeded v3 kernel).
    # ivf=True replaces it with the cluster-pruned IVF index
    # (parallel/sharded_ivf.py, one shard), built from the store with
    # min(ivf_nlist, rows // 8) clusters or reloaded from ivf_dir
    resident: bool = True
    ivf: bool = False
    ivf_nlist: int = 1024
    ivf_nprobe: int = -1  # -1: library default
    ivf_dir: str = ""  # persist/reload the built IVF index
    store_dtype: str = "float32"  # residency dtype: float32|bfloat16|int8
    # int8-weight query tower (serve.Retriever(encoder_int8=True)); with a
    # bfloat16 model dtype it runs the fused LayerNorm-quant and MLP
    # kernels.  Query embeddings move slightly against the float tower
    # (tests/test_torch_serve.py holds the bounds).
    encoder_int8: bool = False
    checkpoint_path: str = ""  # trained query-encoder checkpoint
    embeddings_dir: str = ""  # EmbeddingBlockStore directory
    offset2pid_path: str = ""  # optional offset->pid map (pickle/json)


@dataclass
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    bm25: BM25Config = field(default_factory=BM25Config)
    serve: ServeConfig = field(default_factory=ServeConfig)


_BOOL_FIELDS = {
    f.name
    for cfg in (DataConfig, ModelConfig, TrainConfig, IndexConfig, SearchConfig, BM25Config, ServeConfig)
    for f in fields(cfg)
    if f.type in ("bool", bool)
}


def _coerce(cls, data: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys, coercing bools."""
    names = {f.name: f for f in fields(cls)}
    kw = {}
    for k, v in data.items():
        if k not in names:
            continue
        if k in _BOOL_FIELDS:
            v = parse_bool(v)
        kw[k] = v
    return cls(**kw)


def load_config(path: Optional[str] = None, overrides: Optional[List[str]] = None) -> ExperimentConfig:
    """Load an ExperimentConfig from a TOML file plus key=value overrides.

    TOML layout: either sectioned ([data], [model], ...) or flat (keys are
    routed to every section that declares them, mirroring the reference's
    flat Config/*.toml files).
    Overrides: strings like ``train.learning_rate=3e-5`` or flat
    ``learning_rate=3e-5``.
    """
    sections = {f.name: f.default_factory() for f in fields(ExperimentConfig)}  # type: ignore[misc]
    raw: Dict[str, Any] = _load_toml(path) if path else {}

    flat = {k: v for k, v in raw.items() if not isinstance(v, dict)}
    for name, cfg in sections.items():
        sect = dict(flat)
        sect.update(raw.get(name, {}))
        sections[name] = _coerce(type(cfg), sect)

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, _, val = ov.partition("=")
        key = key.strip()
        if "." in key:
            sect_name, _, fname = key.partition(".")
            targets = [(sect_name, fname)]
        else:
            targets = [
                (name, key)
                for name, cfg in sections.items()
                if key in {f.name for f in fields(type(cfg))}
            ]
            if not targets:
                raise ValueError(f"unknown config key: {key!r}")
        for sect_name, fname in targets:
            cfg = sections[sect_name]
            ftypes = {f.name: f.type for f in fields(type(cfg))}
            if fname not in ftypes:
                raise ValueError(f"unknown config key: {key!r}")
            cur = getattr(cfg, fname)
            if isinstance(cur, bool) and "str" in str(ftypes[fname]):
                # bool|str union fields (model.remat: False/True/"mlp"):
                # boolean-looking strings parse strictly, others pass through
                try:
                    newv: Any = parse_bool(val)
                except ValueError:
                    newv = val
            elif isinstance(cur, bool):
                newv = parse_bool(val)
            elif isinstance(cur, int):
                newv = int(val)
            elif isinstance(cur, float):
                newv = float(val)
            else:
                newv = val
            setattr(cfg, fname, newv)

    return ExperimentConfig(**sections)


def config_from_argv(argv: Optional[List[str]] = None) -> ExperimentConfig:
    """CLI entry: ``prog [--config path.toml] [key=value ...]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--config":
            path = argv[i + 1]
            i += 2
        elif a.startswith("--config="):
            path = a.split("=", 1)[1]
            i += 1
        elif a.startswith("--") and "=" in a:
            overrides.append(a[2:])
            i += 1
        elif "=" in a:
            overrides.append(a)
            i += 1
        else:
            raise ValueError(f"unrecognized argument: {a!r}")
    return load_config(path, overrides)
