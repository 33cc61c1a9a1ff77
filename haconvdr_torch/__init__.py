"""HAConvDR in PyTorch + CUDA on NVIDIA Hopper cards (one, or a mesh).

A second implementation beside the JAX package ``haconvdr_tpu`` (the
reference it is held against in tests/test_torch_*.py).  This package
imports ``torch`` and never ``jax`` or ``haconvdr_tpu``: it keeps its own
copies of the framework-free layers it needs (``config``, ``data.*``,
``eval.*``, ``mine.*``, ``preprocess.*``, ``utils.io``,
``utils.telemetry``, ``index.store``, ``index.rescore``, the numpy half
of ``index.quantize``, and ``index.build``'s ``tokenize_collection``),
with the same names and the same on-disk formats, so a store written by
one package reads in the other.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

Layers, entry point first:
  cli/serve, serve_http     HTTP/JSON daemon (RetrievalServer) over
                            BatchingRetriever; 503 / 504 backpressure
  cli/test_retrieval, test_prj, train_retrieval, gen_doc_embeddings
                            the reference's scripts (--device cuda|cpu)
  cli/gen_tokenized_doc, bm25_search   host-only CLIs (no device)
  serve.py                  Retriever (+ .load) / BatchingRetriever
  retrieval.py              offline evaluation: test queries -> blocked
                            store search -> TREC run + metrics; PRJ labels
  eval/metrics, trec, analysis  trec_eval-style metrics, run files
  mine/prj                  PRJ probes and the MRR-difference judge
  mine/bm25, analysis       BM25 index + native scorer, Lucene analyzer
  preprocess/*              L0 dataset preprocessing (TopiOCQA, QReCC)
  train/trainer             Trainer.fit, make_train_step on a mesh (dp
                            slots, JAX's loss over the whole batch), AdamW
  train/loss                contrastive ranking losses
  train/checkpoint          train-state save / restore (torch.save)
  config                    ModelConfig / DataConfig / TrainConfig / ...
  data/sequence, loader     query construction, fixed-shape batches
  data/topiocqa, qrecc, cast, prj  dataset and probe example builders
  parallel/mesh             device-slot meshes (make_mesh; a device may
                            fill several slots), torch.distributed ranks
  parallel/sharded_encode   encoder runs over data.loader batches, on one
                            device or over a mesh: cut over its dp slots,
                            the tower replicated or Megatron-split over tp
  parallel/sharded_search   device-resident flat index (ShardedIndex),
                            one shard or passage-sharded over a mesh
  parallel/sharded_ivf      IVF build / search / files, cluster-sharded
  index/build, store        corpus encode, tokenized corpus, block store
  index/quantize, rescore   int8 codes and scales, exact second stage
  models/encoder            ANCE RoBERTa tower (inference and train mode;
                            a tp group's split tower, encode_split)
  models/convert            JAX-layout numpy params <-> module state dict;
                            a tp rank's slices (tp_slice)
  models/hf_import          HF checkpoints <-> params; load_model
  utils/telemetry           JSONL event sink (Trainer metrics)
  ops/topk                  block_topk routing, merges, BlockSearcher
  ops/topk_v4               CUDA kernels: v4 window top-2, select, rescore
  ops/fused_topk            CUDA kernel: fused score matmul + exact top-k
  ops/topk_stream           CUDA kernel: v3's split pass unseeded, k <= 1,024 (on no path)
  ops/fused_attention       CUDA kernel: inference attention, fused QKV
  ops/flash_attention       CUDA kernels: trainable attention fwd + bwd
  ops/fused_ln, fused_mlp   CUDA kernels: the int8 tower's LN and MLP (and
                            the MLP's tp split mode)
  ops/_build                nvcc build + ctypes load of csrc/*.cu
  device                    device resolution, dtype map, numpy<->torch
"""

__version__ = "0.1.0"
