"""Everything a run makes from ``--seed``: sub-seeds, the tower's weights
and the index rows.  Both sides get the same: the port as its entry
points take them, the reference regenerated after the window.

Weights follow the reference's init scheme (normal embeddings and dense
kernels of the configuration's ``init_std``, zero biases, unit
LayerNorms) in the nested-dict layout the
port's ``Retriever`` takes (numpy leaves): all normals come from one
``torch.randn`` on the device, copied to the host once.  Index rows are
standard normals made on the device in one call.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (any whole number >= 0)."""
    ss = np.random.SeedSequence([int(seed), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _shapes(model: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in a fixed order."""
    H, I, E = model["hidden_size"], model["intermediate_size"], model["embedding_dim"]
    out = [
        (("embeddings", "word_embeddings"), (model["vocab_size"], H), "normal"),
        (("embeddings", "position_embeddings"), (model["max_position_embeddings"], H), "normal"),
        (("embeddings", "token_type_embeddings"), (model["type_vocab_size"], H), "normal"),
        (("embeddings", "layer_norm", "scale"), (H,), "one"),
        (("embeddings", "layer_norm", "bias"), (H,), "zero"),
    ]
    dense = {"query": (H, H), "key": (H, H), "value": (H, H), "output": (H, H)}
    for li in range(model["num_hidden_layers"]):
        for n, shp in dense.items():
            out.append((("layers", li, "attention", n, "kernel"), shp, "normal"))
            out.append((("layers", li, "attention", n, "bias"), (shp[1],), "zero"))
        out.append((("layers", li, "attention", "output_layer_norm", "scale"), (H,), "one"))
        out.append((("layers", li, "attention", "output_layer_norm", "bias"), (H,), "zero"))
        for n, shp in (("intermediate", (H, I)), ("output", (I, H))):
            out.append((("layers", li, n, "kernel"), shp, "normal"))
            out.append((("layers", li, n, "bias"), (shp[1],), "zero"))
        out.append((("layers", li, "output_layer_norm", "scale"), (H,), "one"))
        out.append((("layers", li, "output_layer_norm", "bias"), (H,), "zero"))
    out += [
        (("embedding_head", "kernel"), (H, E), "normal"),
        (("embedding_head", "bias"), (E,), "zero"),
        (("norm", "scale"), (E,), "one"),
        (("norm", "bias"), (E,), "zero"),
    ]
    return out


def make_params(model: Dict, seed: int, device) -> Dict:
    """The tower's weights from the seed: nested dict of float32 numpy."""
    shapes = _shapes(model)
    total = sum(int(np.prod(s)) for _, s, init in shapes if init == "normal")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = (torch.randn(total, generator=g, device=device) * model["init_std"]).cpu().numpy()
    params: Dict = {"layers": [dict() for _ in range(model["num_hidden_layers"])]}
    at = 0
    for path, shape, init in shapes:
        if init == "normal":
            n = int(np.prod(shape))
            leaf = flat[at:at + n].reshape(shape)
            at += n
        else:
            leaf = (np.ones if init == "one" else np.zeros)(shape, np.float32)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(node, dict) else node[key]
        node[path[-1]] = leaf
    return params


def make_rows(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """[rows, dim] float32 standard normals on the device."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "index"))
    return torch.randn((rows, dim), generator=g, device=device)
