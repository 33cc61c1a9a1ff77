"""HAConvDR in PyTorch + CUDA on one NVIDIA Hopper card.

A second implementation beside the JAX package ``haconvdr_tpu`` (the
reference it is held against in tests/test_torch_*.py).  This package
imports ``torch`` and never ``jax`` or ``haconvdr_tpu``: it keeps its own
copies of the framework-free layers it needs (``config``,
``data.sequence``, ``data.loader``, ``utils.io``, ``index.store``,
``index.rescore``, the numpy half of ``index.quantize``, and
``index.build``'s ``tokenize_collection``), with the same names and the
same on-disk formats, so a store written by one package reads in the
other.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

Layers, entry point first:
  serve.py                  Retriever / BatchingRetriever (query -> pids)
  train/trainer             Trainer.fit, make_train_step, AdamW + clip
  train/loss                contrastive ranking losses
  train/checkpoint          train-state save / restore (torch.save)
  config                    ModelConfig / DataConfig / TrainConfig / ...
  data/sequence, loader     query construction, fixed-shape batches
  parallel/sharded_encode   encoder runs over data.loader batches
  parallel/sharded_search   device-resident flat index (ShardedIndex)
  index/build, store        corpus encode, tokenized corpus, block store
  index/quantize, rescore   int8 codes and scales, exact second stage
  models/encoder            ANCE RoBERTa tower (inference and train mode)
  models/convert            JAX-layout numpy params <-> module state dict
  ops/topk                  block_topk routing, merges, BlockSearcher
  ops/topk_v4               CUDA kernels: v4 window top-2, select, rescore
  ops/fused_topk            CUDA kernel: fused score matmul + exact top-k
  ops/fused_attention       CUDA kernel: inference attention, fused QKV
  ops/flash_attention       CUDA kernels: trainable attention fwd + bwd
  ops/fused_ln, fused_mlp   CUDA kernels: the int8 tower's LN and MLP
  ops/_build                nvcc build + ctypes load of csrc/*.cu
  device                    device resolution, dtype map, numpy<->torch
"""

__version__ = "0.1.0"
