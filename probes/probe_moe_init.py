"""How far the bf16 DeepSeek-V2 tower lies from its float32 reference, and
how far each planted fault moves it, at several initial weight scales, on
one card at the published widths (27 layers, 64 experts):

    python3 <repo>/probes/probe_moe_init.py [--seed 0] [--requests 16] \
        [--scales 0.006:0.006:0.006,0.01:0.02:0.028]

Each scale is ``init_std:expert_init_std:router_init_std[:shared_init_std]``
(``harness/inputs_moe.py``; the shared experts' default: ``init_std``).  For
each it makes the weights from the seed, embeds ``--requests`` requests of
the sessions mix (the longest of a pool of 256, as the cell's check picks
them) with the port's tower (bf16, the expert kernels) and with the
reference (float32), and prints one JSON line: the card; the largest and
median |port - reference| / |reference| a request (``sound``); the same for
the tower with each token's sixth expert left out (``top5``), without the
shared experts (``no_shared``) and with float8 e4m3 weights (``float8``);
and the mean cosine between two requests' reference embeddings.  With
``--diagnose`` also the plain expert twin's distance to the kernels' tower
and the tower's distance to itself with its input embeddings moved by
2^-8 (how far the layers carry a rounding-sized change).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--diagnose", action="store_true",
                    help="also: the plain expert twin against the kernels, and the tower's "
                         "answer to its input embeddings moved by 2^-8")
    ap.add_argument("--scales", default="0.006:0.006:0.006,0.006:0.006:0.028")
    args = ap.parse_args()
    import numpy as np
    import torch

    from h100_bench.harness import inputs_moe
    from h100_bench.harness import traffic as gen
    from h100_bench.reference.deepseek_v2 import Reference
    from h100_bench.reference.query import convqp_ids
    from h100_bench.reference.tokenizer import HashWordTokenizer
    from haconvdr_torch.models import deepseek_v2 as D
    from haconvdr_torch.models.hf_import import deepseek_v2_config
    from haconvdr_torch.ops import moe

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    config = json.loads((ROOT / "h100_bench/configs/deepseek-v2-lite-bf16.json").read_text())
    mix = json.loads((ROOT / "h100_bench/traffic/sessions-c128-decoder.json").read_text())
    sess = gen.Sessions(mix, args.seed)
    pool = sorted(range(256), key=sess.words_of)[-args.requests:]
    tok = HashWordTokenizer(config["vocab_size"])
    L = config["max_concat_length"]
    rows = []
    for j in pool:
        row, n = convqp_ids(tok, *sess.request(j), max_concat=L)
        rows.append(row[:n])
    mask = np.zeros((len(rows), L), np.int64)
    ids = np.zeros_like(mask)
    for b, r in enumerate(rows):
        ids[b, :len(r)], mask[b, :len(r)] = r, 1
    ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    cfg = deepseek_v2_config(config)

    def port(params):
        enc = D.DeepseekV2Encoder.from_params(params, cfg, dev)
        with torch.inference_mode():
            return enc(ids_t, mask_t, host_mask=mask)

    def rel(a, ref):
        e = ((a - ref).norm(dim=-1) / ref.norm(dim=-1)).cpu().numpy()
        return [round(float(e.max()), 4), round(float(np.median(e)), 4)]

    for spec in args.scales.split(","):
        s, es, rs, ss = ([float(x) for x in spec.split(":")] + [None])[:4]
        ss = s if ss is None else ss
        c = dict(config, init_std=s, expert_init_std=es, router_init_std=rs, shared_init_std=ss)
        params = inputs_moe.make_params(c, args.seed, dev)
        ref = Reference(c, params, dev).embed(rows)
        base = port(params)
        out = {"card": card, "init_std": s, "expert_init_std": es, "router_init_std": rs,
               "shared_init_std": ss,
               "sound": rel(base, ref)}
        if args.diagnose:
            enc = D.DeepseekV2Encoder.from_params(params, cfg, dev, plain=True)
            with torch.inference_mode():
                out["plain_vs_kernel"] = rel(enc(ids_t, mask_t, host_mask=mask), base)
            del enc
            emb = params["embed_tokens.weight"]
            g = torch.Generator(device=dev).manual_seed(1)
            nudged = dict(params, **{"embed_tokens.weight": emb + (
                emb.float() * 2.0 ** -8 * torch.randn(emb.shape, generator=g, device=dev)
            ).to(emb.dtype)})
            out["input_nudge_2^-8"] = rel(port(nudged), base)
            del nudged
        routed = moe.routed_experts
        moe.routed_experts = lambda x, g, a, b, k, sc=1.0, **kw: routed(x, g, a, b, k - 1, sc,
                                                                        **kw)
        out["top5"] = rel(port(params), ref)
        moe.routed_experts = routed
        fwd = D.MoE.forward
        D.MoE.forward = lambda self, x: routed(x, self.gate.weight, self.experts.gate_up_proj,
                                               self.experts.down_proj, 6)
        out["no_shared"] = rel(port(params), ref)
        D.MoE.forward = fwd
        del params
        torch.cuda.empty_cache()
        p8 = inputs_moe.make_params(c, args.seed, dev, transform=inputs_moe.float8_e4m3)
        out["float8"] = rel(port(p8), ref)
        del p8
        torch.cuda.empty_cache()
        n = ref / ref.norm(dim=-1, keepdim=True)
        cos = (n @ n.T).cpu().numpy()
        out["cos_between"] = round(float(cos[~np.eye(len(rows), dtype=bool)].mean()), 4)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
