"""End-to-end serving driver on the PyTorch port: batched requests through
prefill + greedy decode on a small model (a llama-family one unless
``--arch`` names another), with the paper's memory machinery active at
both levels — KV-block arena accounting and decode-step operator
reordering.

    PYTHONPATH=src python examples_torch/serve_llm.py               # card
    PYTHONPATH=src python examples_torch/serve_llm.py --device cpu
    PYTHONPATH=src python examples_torch/serve_llm.py --device cpu \
        --arch whisper-large-v3@smoke
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; 'cpu' "
                         "for the plain path)")
    ap.add_argument("--arch", default="llama3.2-3b@smoke",
                    help="the model, a smoke variant: llama3.2-3b@smoke, "
                         "granite-moe-1b-a400m@smoke, zamba2-2.7b@smoke, "
                         "xlstm-350m@smoke, internvl2-1b@smoke (8 zero "
                         "patch embeddings before each prompt) or "
                         "whisper-large-v3@smoke (its encoder over 16 zero "
                         "frames)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    engine = ServingEngine(cfg, params, max_batch=4, cache_len=96,
                           device=device)

    rng = np.random.default_rng(0)
    requests = [Request(rid=i,
                        prompt=rng.integers(0, 500, rng.integers(8, 32))
                        .astype(np.int32),
                        max_new_tokens=16)
                for i in range(10)]

    t0 = time.perf_counter()
    results = engine.serve(requests)
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests / {total_toks} tokens "
          f"in {dt:.2f}s ({total_toks / dt:.1f} tok/s on {device})")
    for r in results[:3]:
        print(f"  req {r.rid}: {r.tokens}")

    print("\nKV arena (paper §4 dynamic allocator):")
    print(f"  per-request block : {engine.block_bytes / 1e6:.2f} MB")
    print(f"  peak arena        : "
          f"{engine.stats['arena_peak_bytes'] / 1e6:.2f} MB "
          f"({engine.stats['peak_concurrent']} concurrent)")
    print(f"  static (all 10)   : {engine.stats['static_bytes'] / 1e6:.2f} MB")

    rep = engine.analyse_decode_schedule(batch_size=4)
    print("\ndecode-step torch.fx reordering (paper Algorithm 1, the layer "
          "stack as one operator):")
    print(f"  {rep}")
    return engine


if __name__ == "__main__":
    main()
