"""How the benchmark calls the port: a configuration file as the port's
ModelConfig, the precisions its tower's work is counted at, and the
process's garbage collector around the window."""

from __future__ import annotations

import gc
from typing import Dict

import torch


def port_config(config: Dict):
    """The port's ModelConfig of a configuration file."""
    from haconvdr_torch.config import ModelConfig

    return ModelConfig(
        model_type="ANCE", hidden_size=config["hidden_size"],
        num_hidden_layers=config["num_hidden_layers"],
        num_attention_heads=config["num_attention_heads"],
        intermediate_size=config["intermediate_size"], vocab_size=config["vocab_size"],
        max_position_embeddings=config["max_position_embeddings"],
        type_vocab_size=config["type_vocab_size"], pad_token_id=config["pad_token_id"],
        layer_norm_eps=config["layer_norm_eps"], embedding_dim=config["embedding_dim"],
        dtype=config["tower"]["dtype"],
    )


def tower_rates(config: Dict) -> Dict:
    """The precisions the tower's work is counted at (harness/work.py)."""
    t = config["tower"]
    if t["int8"]:
        return {"dense": "int8", "attention": t["dtype"], "head": t["dtype"], "weight_bytes": 1}
    return {"dense": t["dtype"], "attention": t["dtype"], "head": t["dtype"], "weight_bytes": 4}


def settle() -> None:
    """The last step of set-up: collect, then freeze what set-up made
    (torch, the port's objects, the inputs) into the collector's permanent
    generation, so a full collection inside the window scans only what
    the window made: without it one such collection stopped every thread
    for 0.18-0.48 s on an H100 host, a stall whose count varied run to run
    and moved the tail.  The port's serving entry points do not freeze:
    each configuration lists this under ``assumed`` as the deployment's
    setting.  ``release`` undoes it before the reference runs."""
    gc.collect()
    gc.freeze()


def window_peak_start(device) -> int:
    """The device's peak so far (set-up's, with its short-lived staging
    buffers), then the peak reset, so that the run's ``memory_peak_bytes``
    is what the window holds at its fullest."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return int(peak)


def release(device) -> None:
    """Unfreeze and collect (the port's objects may hold cycles), then
    return the freed device memory."""
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
