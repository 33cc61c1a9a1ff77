"""CLI: online retrieval serving daemon (counterpart of
haconvdr_tpu/cli/serve.py).

Loads a trained query-encoder checkpoint and an embedding store
(``Retriever.load``), keeps the index resident on the card (float32,
bfloat16 or int8, ``serve.store_dtype``), streams its blocks
(``serve.resident=false``) or serves the IVF index (``serve.ivf=true``,
built from the store or reloaded from ``serve.ivf_dir``), and serves the
HTTP/JSON API (haconvdr_torch/serve_http.py) until SIGINT.

Usage: python -m haconvdr_torch.cli.serve --config cfg.toml
       [serve.port=8080 serve.store_dtype=int8 search.rescore_oversample=5 ...]
       [--device cuda|cpu]

The tower and the index run on the mesh of ``--device``: every visible
CUDA card by default (the index sharded over them, refusing to start
without one), one card with ``cuda:N``, the plain twins with ``--device
cpu``.
"""

import logging

from haconvdr_torch.cli._args import device_mesh, pop_device
from haconvdr_torch.config import config_from_argv
from haconvdr_torch.serve import Retriever
from haconvdr_torch.serve_http import RetrievalServer
from haconvdr_torch.utils.io import pload, setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    mesh = device_mesh(device)  # raises without the card before any read
    cfg = config_from_argv(argv)
    cfg.data.is_train = False  # serving builds eval-style concats
    cfg.data.use_PRL = False
    s = cfg.serve
    if not s.checkpoint_path or not s.embeddings_dir:
        raise SystemExit("serve.checkpoint_path and serve.embeddings_dir are required")
    offset2pid = pload(s.offset2pid_path) if s.offset2pid_path else None
    retriever = Retriever.load(
        s.checkpoint_path,
        s.embeddings_dir,
        model_type=cfg.model.model_type,
        offset2pid=offset2pid,
        data_cfg=cfg.data,
        search_cfg=cfg.search,
        resident=s.resident,
        store_dtype=s.store_dtype,
        ivf=s.ivf,
        ivf_nlist=s.ivf_nlist,
        ivf_nprobe=None if s.ivf_nprobe < 0 else s.ivf_nprobe,
        ivf_dir=s.ivf_dir or None,
        encoder_int8=s.encoder_int8,
        mesh=mesh,
    )
    server = RetrievalServer(
        retriever,
        host=s.host,
        port=s.port,
        max_batch=s.max_batch,
        max_wait_ms=s.max_wait_ms,
        queue_depth=s.queue_depth,
        request_timeout_s=s.request_timeout_s,
    )
    logger.info(
        "serving %s/%s on %s at http://%s:%d (max_batch=%d, wait=%.1fms)",
        "resident" if s.resident else "streamed", s.store_dtype, mesh,
        server.host, server.port, s.max_batch, s.max_wait_ms,
    )
    server.run()
    return server


if __name__ == "__main__":
    main()
