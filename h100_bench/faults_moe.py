"""The DeepSeek-V2 cell's faults and its float8 control, each planted under
one whole run of the cell (set-up, window, check) at its own size on the
card, to see its check come out not correct:

    python3 h100_bench/faults_moe.py --workload dsv2lite-sessions-c128 --seed <n> \
        --seconds 5 --faults float8,top5,no_shared,stale,altered_search

It prints a line a fault: the fault, ``correct`` and each number beside its
limit.  A name joined by ``+`` plants its parts together
(``bf16_stream+top5``).

* ``float8``: the control: every attention, dense and expert kernel the
  port takes rounded to float8 e4m3 with a per-matrix scale
  (``harness/inputs_moe.float8_e4m3``); the reference keeps the seed's
  bf16 weights;
* ``top5``: each token's sixth routed expert left out (the top 5 of the
  same softmax, not renormalized);
* ``no_shared``: the shared experts left out;
* ``stale``: the tower returns its previous output of the same shape
  (``faults.stale``);
* ``altered_search``: the first query's best passage swapped for its k-th
  (``faults.altered_search``);
* ``bf16_stream``: no fault, the published arithmetic the tower departs
  from: its residual stream rounded to bfloat16 at each layer's input and
  after each of its two adds (the port keeps it in float32), to read the
  sound runs' numbers, and a fault's, beside the port's.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import faults  # noqa: E402


def _top5(routed):
    def f(x, gate_weight, w13, w2, top_k, scale=1.0, **kw):
        return routed(x, gate_weight, w13, w2, top_k - 1, scale, **kw)
    return f


def _no_shared(forward):
    def f(self, x):
        shared, self.shared_experts = self.shared_experts, None
        try:
            return forward(self, x)
        finally:
            self.shared_experts = shared
    return f


def _bf16_stream(forward):
    import torch

    from haconvdr_torch.models.deepseek_v2 import rms_norm

    def f(self, x, fwd):
        eps = self.cfg.rms_norm_eps
        x = x.to(torch.bfloat16)
        x = x + self.self_attn(rms_norm(x, self.input_layernorm.weight, eps), fwd)
        x = (x + self.mlp(rms_norm(x, self.post_attention_layernorm.weight, eps))).to(x.dtype)
        return x.float()
    return f


def _float8(port_params):
    from h100_bench.harness import inputs_moe

    def f(config, seed, device):
        return inputs_moe.make_params(config, seed, device, transform=inputs_moe.float8_e4m3)
    return f


@contextlib.contextmanager
def planted(name: str, driver):
    """The port (or, for ``float8``, the weights it takes) patched with
    fault ``name`` (its ``+``-joined parts) inside the block."""
    with contextlib.ExitStack() as stack:
        for part in name.split("+"):
            stack.enter_context(_planted(part, driver))
        yield


@contextlib.contextmanager
def _planted(name: str, driver):
    if name == "stale":
        from haconvdr_torch.models.deepseek_v2 import DeepseekV2Encoder as owner
        attr, wrap = "forward", faults.stale
    elif name == "altered_search":
        from haconvdr_torch.parallel.sharded_search import ShardedIndex as owner
        attr, wrap = "search", faults.altered_search
    elif name == "top5":
        from haconvdr_torch.ops import moe as owner
        attr, wrap = "routed_experts", _top5
    elif name == "no_shared":
        from haconvdr_torch.models.deepseek_v2 import MoE as owner
        attr, wrap = "forward", _no_shared
    elif name == "float8":
        owner, attr, wrap = driver, "port_params", _float8
    elif name == "bf16_stream":
        from haconvdr_torch.models.deepseek_v2 import DecoderLayer as owner
        attr, wrap = "forward", _bf16_stream
    else:
        raise ValueError(f"no fault {name!r}")
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the DeepSeek-V2 cell's check with faults planted")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", required=True, help="comma-separated fault names")
    args = ap.parse_args(argv)

    import torch

    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.runner import execute

    if not torch.cuda.is_available():
        print("faults_moe.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for name in args.faults.split(","):
        with planted(name, cell.driver):
            line, correct = execute(cell, args.seed, args.seconds, False, device,
                                    time.perf_counter())
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "seed": args.seed, "fault": name,
                          "correct": correct, "checks": line["checks"],
                          "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
