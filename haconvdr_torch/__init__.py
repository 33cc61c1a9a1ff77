"""HAConvDR in PyTorch + CUDA: the serving path on one NVIDIA Hopper card.

A second implementation beside the JAX package ``haconvdr_tpu`` (the
reference it is held against in tests/test_torch_*.py).  This package
imports ``torch`` and never ``jax``.  Framework-free host layers
(``haconvdr_tpu.config``, ``data.sequence``, ``data.loader``,
``index.store``, ``index.rescore``) are shared, not copied.

Layers, entry point first:
  serve.py                  Retriever / BatchingRetriever (query -> pids)
  parallel/sharded_encode   encoder runs over data.loader batches
  parallel/sharded_search   device-resident flat index (ShardedIndex)
  models/encoder            ANCE RoBERTa query tower (inference)
  models/convert            JAX-layout numpy params -> module state dict
  ops/topk                  exact top-k per block, merges, BlockSearcher
  ops/fused_topk            CUDA kernel: fused score matmul + exact top-k
  ops/fused_attention       CUDA kernel: attention from the fused QKV
  ops/_build                nvcc build + ctypes load of csrc/*.cu
  device                    device resolution, dtype map, numpy<->torch
"""

__version__ = "0.1.0"
