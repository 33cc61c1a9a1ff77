"""The work of the DeepSeek-V2 tower's inputs, whatever implements it
(``harness/work.py`` counts ANCE's).

A request of l valid tokens takes 2 x (active parameters) x l operations
(every layer's attention projections, the dense layers' SwiGLU, and in each
expert layer the router, ``num_experts_per_tok`` routed experts and the
shared experts, each expert 3 x H x I; the embedding is a lookup and the LM
head is dropped), plus causal attention, 2 x heads x (qk + v head dims) x
l (l + 1) / 2 a layer.  Padding and a bucket's copies are never work.
Bytes: every weight read once a call (the embedding's looked-up rows
aside).  All of it at bf16's rate.

The expert layer alone (``expert_work``): 2 x T x k x 3 x H x I operations
a layer for T tokens, and the routed experts' weights read once a call.
"""

from __future__ import annotations

from typing import Dict, Iterable

from h100_bench.harness.inputs_moe import expert_layer
from h100_bench.harness.work import Work

BF16 = "bfloat16"


def _attention_params(m: Dict) -> int:
    H, nh = m["hidden_size"], m["num_attention_heads"]
    dn, dr, dv, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"]
    return H * nh * (dn + dr) + H * (r + dr) + r * nh * (dn + dv) + nh * dv * H


def _expert_params(m: Dict) -> int:
    return 3 * m["hidden_size"] * m["moe_intermediate_size"]


def active_params(m: Dict) -> int:
    """Parameters a token multiplies by."""
    H, E = m["hidden_size"], m["n_routed_experts"]
    total = 0
    for i in range(m["num_hidden_layers"]):
        total += _attention_params(m)
        if expert_layer(m, i):
            total += H * E + (m["num_experts_per_tok"] + m["n_shared_experts"]) * _expert_params(m)
        else:
            total += 3 * H * m["intermediate_size"]
    return total


def weight_count(m: Dict) -> int:
    """Parameters of the matrices a call reads (the embedding aside)."""
    H, E = m["hidden_size"], m["n_routed_experts"]
    total = 0
    for i in range(m["num_hidden_layers"]):
        total += _attention_params(m)
        if expert_layer(m, i):
            total += H * E + (E + m["n_shared_experts"]) * _expert_params(m)
        else:
            total += 3 * H * m["intermediate_size"]
    return total


def expert_layers(m: Dict) -> int:
    return sum(expert_layer(m, i) for i in range(m["num_hidden_layers"]))


def tower_work(lengths: Iterable[int], m: Dict) -> Work:
    """One call of the tower over requests of these valid lengths."""
    P = active_params(m)
    per_pair = 2.0 * m["num_attention_heads"] * (
        m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]) * m["num_hidden_layers"]
    w = Work(nbytes=2.0 * weight_count(m))
    for n in lengths:
        w.ops[BF16] += 2.0 * P * n + per_pair * n * (n + 1) / 2
    return w


def expert_work(tokens: int, m: Dict) -> Work:
    """The routed experts of one call of the tower over ``tokens`` rows:
    every expert layer's grouped products, and its experts' weights."""
    n = expert_layers(m)
    ex = _expert_params(m)
    return Work({BF16: 2.0 * tokens * m["num_experts_per_tok"] * ex * n},
                2.0 * m["n_routed_experts"] * ex * n)
