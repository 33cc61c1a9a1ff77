"""Parameters across the two packages.

The JAX package keeps encoder params as a nested dict
(haconvdr_tpu/models/encoder.py:init_encoder_params): dense ``kernel``s are
[in, out], LayerNorms have ``scale``/``bias``, ``layers`` is a list (or a
stacked dict).  The port's ``AnceEncoder`` is an ``nn.Module`` with
``nn.Linear`` weights [out, in] and one fused [3H, H] QKV weight per
layer.  ``params_from_jax`` maps the first onto the second, int8-quantized
kernels included (``kernel`` int8 plus ``kernel_scale`` [out]: the
module's ``Int8Linear`` buffers); ``params_to_jax`` maps a float state
dict back (trained weights compared with the JAX package's);
``init_params_numpy`` makes the first
with numpy from a seed, so that tests and chip_smoke.py hand identical
weights to both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from haconvdr_torch.config import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _unstack(layers) -> list:
    if isinstance(layers, list):
        return layers
    # stacked layout: every leaf carries a leading [num_layers] axis
    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    n = np.asarray(layers["attention"]["query"]["kernel"]).shape[0]
    return [pick(layers, i) for i in range(n)]


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX nested-dict params (numpy-convertible leaves, list or stacked
    layout) -> AnceEncoder state dict (CPU tensors): float32, and for
    int8-quantized dense layers int8 ``weight`` [out, in] with float32
    ``kernel_scale`` [out]."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, parts):
        """One dense from the JAX dicts ``parts`` concatenated along the
        output axis (the fused q|k|v, with its per-channel scales)."""
        kernel = np.concatenate([np.asarray(p["kernel"]) for p in parts], axis=1).T
        if "kernel_scale" in parts[0]:
            sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(kernel, np.int8))
            sd[prefix + ".kernel_scale"] = _t(np.concatenate([p["kernel_scale"] for p in parts]))
        else:
            sd[prefix + ".weight"] = _t(kernel)
        sd[prefix + ".bias"] = _t(np.concatenate([np.asarray(p["bias"]) for p in parts]))

    def ln(prefix, p):
        sd[prefix + ".weight"] = _t(p["scale"])
        sd[prefix + ".bias"] = _t(p["bias"])

    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = _t(emb[name])
    ln("embeddings.layer_norm", emb["layer_norm"])
    for li, layer in enumerate(_unstack(params["layers"])):
        a = layer["attention"]
        pre = f"layers.{li}"
        dense(f"{pre}.attention.qkv", [a["query"], a["key"], a["value"]])
        dense(f"{pre}.attention.output", [a["output"]])
        ln(f"{pre}.attention.output_layer_norm", a["output_layer_norm"])
        dense(f"{pre}.intermediate", [layer["intermediate"]])
        dense(f"{pre}.output", [layer["output"]])
        ln(f"{pre}.output_layer_norm", layer["output_layer_norm"])
    dense("embedding_head", [params["embedding_head"]])
    ln("norm", params["norm"])
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor], stacked: bool = False) -> Dict[str, Any]:
    """Inverse of ``params_from_jax`` for float towers: an AnceEncoder
    state dict -> the JAX package's nested dict with float32 numpy leaves,
    ``layers`` as a list or, with ``stacked``, one dict of [num_layers, ...]
    leaves."""
    sd = {k: v.detach().to(torch.float32).cpu().numpy().copy() for k, v in state_dict.items()}
    if any(k.endswith("kernel_scale") for k in sd):
        raise ValueError("params_to_jax takes float towers, not int8 ones")

    def dense(prefix, parts=1):
        kernels = np.split(sd[prefix + ".weight"].T, parts, axis=1)
        biases = np.split(sd[prefix + ".bias"], parts)
        out = [{"kernel": np.ascontiguousarray(k), "bias": b} for k, b in zip(kernels, biases)]
        return out if parts > 1 else out[0]

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    n = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    layers = []
    for li in range(n):
        pre = f"layers.{li}"
        q, k, v = dense(f"{pre}.attention.qkv", 3)
        layers.append({
            "attention": {
                "query": q, "key": k, "value": v,
                "output": dense(f"{pre}.attention.output"),
                "output_layer_norm": ln(f"{pre}.attention.output_layer_norm"),
            },
            "intermediate": dense(f"{pre}.intermediate"),
            "output": dense(f"{pre}.output"),
            "output_layer_norm": ln(f"{pre}.output_layer_norm"),
        })
    if stacked:
        def stack(*xs):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]} if isinstance(xs[0], dict) else np.stack(xs)

        layers = stack(*layers)
    emb = {name: sd[f"embeddings.{name}.weight"]
           for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    emb["layer_norm"] = ln("embeddings.layer_norm")
    return {"embeddings": emb, "layers": layers, "embedding_head": dense("embedding_head"),
            "norm": ln("norm")}


def init_params_numpy(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Random params in the JAX package's layout (list of layers), drawn
    with numpy: normal(0, 0.02) for embeddings and dense kernels, zero
    biases, unit LayerNorm scales (the reference's init scheme,
    haconvdr_tpu/models/encoder.py:50-87).  float32 numpy leaves."""
    rng = np.random.default_rng(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02))

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": np.zeros((o,), np.float32)}

    def ln(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    params: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": normal(cfg.vocab_size, H),
            "position_embeddings": normal(cfg.max_position_embeddings, H),
            "token_type_embeddings": normal(cfg.type_vocab_size, H),
            "layer_norm": ln(H),
        },
        "layers": [],
        "embedding_head": dense(H, cfg.embedding_dim),
        "norm": ln(cfg.embedding_dim),
    }
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append(
            {
                "attention": {
                    "query": dense(H, H),
                    "key": dense(H, H),
                    "value": dense(H, H),
                    "output": dense(H, H),
                    "output_layer_norm": ln(H),
                },
                "intermediate": dense(H, I),
                "output": dense(I, H),
                "output_layer_norm": ln(H),
            }
        )
    return params
