"""HAConvDR in PyTorch + CUDA: the serving path on one NVIDIA Hopper card.

A second implementation beside the JAX package ``haconvdr_tpu`` (the
reference it is held against in tests/test_torch_*.py).  This package
imports ``torch`` and never ``jax``.  Framework-free host layers
(``haconvdr_tpu.config``, ``data.sequence``, ``data.loader``,
``index.store``, ``index.rescore``, ``index.quantize``) are shared, not
copied; callers take the configs from ``haconvdr_torch.config`` and
``batch_iter`` from ``parallel.sharded_encode``.

Layers, entry point first:
  serve.py                  Retriever / BatchingRetriever (query -> pids)
  config                    ModelConfig / DataConfig / SearchConfig
  parallel/sharded_encode   encoder runs over data.loader batches
  parallel/sharded_search   device-resident flat index (ShardedIndex)
  models/encoder            ANCE RoBERTa query tower (inference)
  models/convert            JAX-layout numpy params -> module state dict
  index/quantize            int8 codes and scales (host and device)
  ops/topk                  block_topk routing, merges, BlockSearcher
  ops/topk_v4               CUDA kernels: v4 window top-2, select, rescore
  ops/fused_topk            CUDA kernel: fused score matmul + exact top-k
  ops/fused_attention       CUDA kernel: attention from the fused QKV
  ops/_build                nvcc build + ctypes load of csrc/*.cu
  device                    device resolution, dtype map, numpy<->torch
"""

__version__ = "0.1.0"
