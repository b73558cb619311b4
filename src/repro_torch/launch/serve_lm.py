"""Serve an LM with batched KV-cache decoding (prefill + greedy decode) —
the port's counterpart of the reference's ``examples/serve_lm.py``, as a
CLI:

  python -m repro_torch.launch.serve_lm --arch qwen2-7b --config smoke
  python -m repro_torch.launch.serve_lm --arch qwen2-7b --config full \\
      --batch 4 --prompt-len 12 --gen-len 20 --max-len 64 --seed 0
  python -m repro_torch.launch.serve_lm ... --device cpu

The example's loop: random weights from ``--seed``, prompts of ids in
[1, vocab) from numpy's generator of the same seed, the cache filled by
one ``decode_step`` a prompt position, then greedy generation over
``logits[:, :vocab]``. Prints the generated ids of the first request,
the tokens per second with the device's name, and a JSON summary line;
exits 1 if the generated ids fail the example's checks (shape (batch,
gen_len), every id in [0, vocab)). Runs on the CUDA device unless
``--device`` names another (``cpu`` on purpose); without one it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def generate(params, cfg, prompts, gen_len: int, max_len: int):
    """Greedy continuation of ``prompts`` ((B, P) ids, a tensor on the
    parameters' device): ``gen_len`` ids a request, (B, gen_len) int64.
    The cache holds ``max_len`` positions."""
    import torch

    from ..models import transformer as T
    from ..models.common import tree_map_specs

    B, prompt_len = prompts.shape
    if prompt_len < 1 or prompt_len + gen_len > max_len:
        raise ValueError(f"{prompt_len} prompt and {gen_len} generated "
                         f"positions must fit a cache of {max_len}")
    dev = prompts.device
    cache = tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        T.cache_specs(cfg, B, max_len))

    def step(tok, t):
        lens = torch.full((B,), t, dtype=torch.int64, device=dev)
        logits, _ = T.decode_step(params, cache, tok, lens, cfg)
        return torch.argmax(logits[:, :cfg.vocab], dim=-1)

    # prefill: run the prompt through decode steps to fill the cache
    for t in range(prompt_len):
        tok = step(prompts[:, t], t)
    out = []
    for t in range(prompt_len, prompt_len + gen_len):
        out.append(tok)
        tok = step(tok, t)
    return torch.stack(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b",
                    help="an LM of the registry (qwen2-7b, gemma-2b, "
                         "stablelm-12b, granite-moe-1b-a400m, arctic-480b)")
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=20)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                         "device; 'cpu' on purpose)")
    args = ap.parse_args(argv)
    if args.prompt_len < 1 or args.prompt_len + args.gen_len > args.max_len:
        ap.error("--prompt-len must be at least 1 and --prompt-len + "
                 "--gen-len at most --max-len")

    import torch

    from .. import configs
    from ..kernels.dispatch import NoCudaDevice, resolve_device
    from ..models import transformer as T
    from ..models.common import init_params

    try:
        dev = resolve_device(args.device)
    except NoCudaDevice as exc:
        print(f"serve_lm: no CUDA device ({exc}); pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    entry = configs.get(args.arch)
    if entry.kind != "lm":
        ap.error(f"{args.arch} is not an LM")
    cfg = entry.config if args.config == "full" else entry.smoke_config
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(T.build_specs(cfg), gen, device=dev)
    rng = np.random.default_rng(args.seed)
    B = args.batch
    prompts = torch.as_tensor(
        rng.integers(1, cfg.vocab, (B, args.prompt_len)), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompts, args.gen_len, args.max_len)
    sync()
    dt = time.perf_counter() - t0
    toks = toks.cpu().numpy()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    steps = args.prompt_len + args.gen_len
    print(f"generated {B}x{args.gen_len} tokens in {dt:.3f} s "
          f"({B * steps / dt:.1f} tok/s over {steps} decode steps, prompt "
          f"included) on {name}")
    print("sample token ids:", toks[0].tolist())
    ok = toks.shape == (B, args.gen_len) and bool(
        ((toks >= 0) & (toks < cfg.vocab)).all())
    print(json.dumps({"arch": args.arch, "config": args.config,
                      "batch": B, "prompt_len": args.prompt_len,
                      "gen_len": args.gen_len, "max_len": args.max_len,
                      "seconds": dt, "tokens_per_s": B * steps / dt,
                      "device": name, "ok": ok}))
    if not ok:
        print(f"serve_lm: generated ids of shape {toks.shape} or outside "
              f"[0, {cfg.vocab})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
