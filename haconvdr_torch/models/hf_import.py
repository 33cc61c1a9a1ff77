"""HF-torch checkpoint interop for the ANCE/BERT encoder (counterpart of
haconvdr_tpu/models/hf_import.py:31-179).

The reference loads ``ad-hoc-ance-msmarco`` through ``ANCE.from_pretrained``
and saves fine-tuned encoders with ``save_pretrained``.  These functions
map an HF state dict (``pytorch_model.bin`` or ``model.safetensors`` in a
local directory) to and from the JAX package's nested-dict params with
numpy leaves, the layout ``AnceEncoder.from_jax_params`` and
``quantize_encoder_params`` take.  The JAX module cannot be shared: it
imports JAX through ``models.encoder``.  ``load_model`` gives the
tokenizer and an ``AnceEncoder``; the tokenizer needs ``transformers``,
which ``load_tokenizer`` imports only when it is called.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from haconvdr_torch.config import ModelConfig
from haconvdr_torch.device import DeviceLike, resolve_device
from haconvdr_torch.models.encoder import AnceEncoder

EncoderParams = Dict[str, Any]


def config_from_hf(path: str, model_type: str = "ANCE") -> ModelConfig:
    """``config.json`` of an HF checkpoint -> ModelConfig (dtype stays the
    default float32, as in the reference)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    return ModelConfig(
        model_type=model_type,
        pretrained_encoder_path=path,
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 1),
        pad_token_id=hf.get("pad_token_id", 1),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
    )


def _read_state_dict(path: str) -> Dict[str, np.ndarray]:
    st_path = os.path.join(path, "model.safetensors")
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        return load_file(st_path)
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.detach().cpu().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no pytorch_model.bin or model.safetensors under {path}")


def _prefix(cfg: ModelConfig) -> str:
    return "bert" if cfg.model_type.upper().startswith("BERT") else "roberta"


def params_from_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> EncoderParams:
    """HF ANCE (RobertaForSequenceClassification + embeddingHead/norm) or
    BERT state dict -> nested-dict params (float32 numpy, list layout)."""
    prefix = _prefix(cfg)

    def get(name):
        for cand in (name, f"{prefix}.{name}"):
            if cand in sd:
                return np.asarray(sd[cand], np.float32)
        raise KeyError(f"missing weight {name!r} (prefix {prefix})")

    def dense(name):
        return {"kernel": get(f"{name}.weight").T, "bias": get(f"{name}.bias")}

    def ln(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    params: EncoderParams = {
        "embeddings": {
            "word_embeddings": get("embeddings.word_embeddings.weight"),
            "position_embeddings": get("embeddings.position_embeddings.weight"),
            "token_type_embeddings": get("embeddings.token_type_embeddings.weight"),
            "layer_norm": ln("embeddings.LayerNorm"),
        },
        "layers": [],
        # the head lives at the top level of the ANCE module
        "embedding_head": {"kernel": np.asarray(sd["embeddingHead.weight"], np.float32).T,
                           "bias": np.asarray(sd["embeddingHead.bias"], np.float32)},
        "norm": {"scale": np.asarray(sd["norm.weight"], np.float32),
                 "bias": np.asarray(sd["norm.bias"], np.float32)},
    }
    for i in range(cfg.num_hidden_layers):
        base = f"encoder.layer.{i}"
        params["layers"].append(
            {
                "attention": {
                    "query": dense(f"{base}.attention.self.query"),
                    "key": dense(f"{base}.attention.self.key"),
                    "value": dense(f"{base}.attention.self.value"),
                    "output": dense(f"{base}.attention.output.dense"),
                    "output_layer_norm": ln(f"{base}.attention.output.LayerNorm"),
                },
                "intermediate": dense(f"{base}.intermediate.dense"),
                "output": dense(f"{base}.output.dense"),
                "output_layer_norm": ln(f"{base}.output.LayerNorm"),
            }
        )
    return params


def state_dict_from_params(params: EncoderParams, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_state_dict`` (list layout), for export."""
    prefix = _prefix(cfg)
    sd: Dict[str, np.ndarray] = {}

    def put_dense(name, p):
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_ln(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{prefix}.embeddings.{name}.weight"] = np.asarray(emb[name])
    put_ln(f"{prefix}.embeddings.LayerNorm", emb["layer_norm"])
    for i, layer in enumerate(params["layers"]):
        base = f"{prefix}.encoder.layer.{i}"
        for part in ("query", "key", "value"):
            put_dense(f"{base}.attention.self.{part}", layer["attention"][part])
        put_dense(f"{base}.attention.output.dense", layer["attention"]["output"])
        put_ln(f"{base}.attention.output.LayerNorm", layer["attention"]["output_layer_norm"])
        put_dense(f"{base}.intermediate.dense", layer["intermediate"])
        put_dense(f"{base}.output.dense", layer["output"])
        put_ln(f"{base}.output.LayerNorm", layer["output_layer_norm"])
    put_dense("embeddingHead", params["embedding_head"])
    put_ln("norm", params["norm"])
    return sd


def load_hf_checkpoint(path: str, model_type: str = "ANCE") -> Tuple[EncoderParams, ModelConfig]:
    cfg = config_from_hf(path, model_type)
    return params_from_state_dict(_read_state_dict(path), cfg), cfg


def save_hf_checkpoint(params: EncoderParams, cfg: ModelConfig, out_dir: str) -> None:
    """Write an HF-format directory (config.json + pytorch_model.bin),
    loadable by the reference's ANCE.from_pretrained."""
    os.makedirs(out_dir, exist_ok=True)
    sd = state_dict_from_params(params, cfg)
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
               os.path.join(out_dir, "pytorch_model.bin"))
    hf_cfg = {
        "model_type": _prefix(cfg),
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "intermediate_size": cfg.intermediate_size,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "pad_token_id": cfg.pad_token_id,
        "layer_norm_eps": cfg.layer_norm_eps,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)


def load_tokenizer(model_type: str, path: str):
    """The HF tokenizer saved beside a checkpoint: ``BertTokenizer`` for a
    ``"BERT*"`` model type, ``RobertaTokenizer`` otherwise, lower-cased as
    the reference loads it (src/models.py:112-136).  ``transformers`` is
    imported here, not at module import."""
    if model_type.upper().startswith("BERT"):
        from transformers import BertTokenizer as cls
    else:
        from transformers import RobertaTokenizer as cls
    return cls.from_pretrained(path, do_lower_case=True)


def load_checkpoint(model_type: str, path: str):
    """(tokenizer, params, ModelConfig) of an HF checkpoint directory for
    ``"ANCE_*"`` / ``"BERT_*"`` (or ``"ANCE"`` / ``"BERT"``); any other
    family raises ValueError, as the reference's factory does."""
    base = model_type.split("_")[0].upper()
    if base not in ("ANCE", "BERT"):
        raise ValueError(f"unknown model type {model_type!r}")
    params, cfg = load_hf_checkpoint(path, base)
    return load_tokenizer(base, path), params, cfg


def load_model(model_type: str, model_path: str, device: DeviceLike = None):
    """The reference's factory (src/models.py:112-136; the JAX package's
    haconvdr_tpu/models/hf_import.py:182): ``"ANCE_Query"`` /
    ``"ANCE_Passage"`` / ``"BERT_*"`` -> (tokenizer, ``AnceEncoder`` on
    ``device``, the CUDA card unless told ``"cpu"``)."""
    dev = resolve_device(device)  # raises without the card before any read
    tokenizer, params, cfg = load_checkpoint(model_type, model_path)
    return tokenizer, AnceEncoder.from_jax_params(params, cfg, dev)
