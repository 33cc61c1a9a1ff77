"""The DeepSeek-V2 tower's weights from ``--seed``, made on the card in
bfloat16 (the whole model is 31.0 GB at DeepSeek-V2-Lite's widths: no host
copy), under the names the port's ``models/deepseek_v2.py`` and the
reference (``reference/deepseek_v2.py``) take.  Both sides regenerate them
from the seed alike.

Each kernel is normal(0, std) drawn in float32 on the device and rounded
once to bfloat16, one generator in a fixed order: ``init_std`` for the
embeddings, attention and dense kernels, ``router_init_std`` for the
routers', ``expert_init_std`` for the routed experts' and
``shared_init_std`` for the shared experts' (the configuration says why);
RMSNorm weights are ones.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from h100_bench.harness.inputs import sub_seed


def expert_layer(model: Dict, i: int) -> bool:
    return i >= model["first_k_dense_replace"] and i % model["moe_layer_freq"] == 0


def shapes(model: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight, in the generator's order; init
    is "one", "std", "router", "expert" or "shared"."""
    H, V, nh = model["hidden_size"], model["vocab_size"], model["num_attention_heads"]
    dn, dr, dv = model["qk_nope_head_dim"], model["qk_rope_head_dim"], model["v_head_dim"]
    r, E, I = model["kv_lora_rank"], model["n_routed_experts"], model["moe_intermediate_size"]
    out = [("embed_tokens.weight", (V, H), "std")]
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "input_layernorm.weight", (H,), "one"),
            (p + "self_attn.q_proj.weight", (nh * (dn + dr), H), "std"),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (r + dr, H), "std"),
            (p + "self_attn.kv_a_layernorm.weight", (r,), "one"),
            (p + "self_attn.kv_b_proj.weight", (nh * (dn + dv), r), "std"),
            (p + "self_attn.o_proj.weight", (H, nh * dv), "std"),
            (p + "post_attention_layernorm.weight", (H,), "one"),
        ]
        if expert_layer(model, i):
            Is = I * model["n_shared_experts"]
            out += [
                (p + "mlp.gate.weight", (E, H), "router"),
                (p + "mlp.experts.gate_up_proj", (E, 2 * I, H), "expert"),
                (p + "mlp.experts.down_proj", (E, H, I), "expert"),
                (p + "mlp.shared_experts.gate_up_proj.weight", (2 * Is, H), "shared"),
                (p + "mlp.shared_experts.down_proj.weight", (H, Is), "shared"),
            ]
        else:
            Id = model["intermediate_size"]
            out += [(p + "mlp.gate_up_proj.weight", (2 * Id, H), "std"),
                    (p + "mlp.down_proj.weight", (H, Id), "std")]
    out.append(("norm.weight", (H,), "one"))
    return out


def make_params(model: Dict, seed: int, device,
                transform: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Every weight, bfloat16 on ``device``; ``transform(name, w)`` (the
    float8 control) replaces a weight as it is made."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    std = {"std": model["init_std"], "expert": model["expert_init_std"],
           "router": model["router_init_std"], "shared": model["shared_init_std"]}
    params = {}
    for name, shape, init in shapes(model):
        if init == "one":
            w = torch.ones(shape, dtype=torch.bfloat16, device=device)
        else:
            w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            w = w.mul_(std[init]).to(torch.bfloat16)
        params[name] = w if transform is None else transform(name, w)
    return params


def float8_e4m3(name: str, w: torch.Tensor) -> torch.Tensor:
    """The control's weights: every attention, dense and expert kernel
    (``*proj*``; each expert's matrix on its own) rounded to float8 e4m3 with
    a per-matrix scale (max |w| / 448), back in bfloat16."""
    if "proj" not in name or w.dim() < 2:
        return w
    scale = w.float().abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30) / 448.0
    return ((w.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)
