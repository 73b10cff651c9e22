"""Serving launcher: batched LLM requests through the ``ServingEngine``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --max-new 12

The same flags as the reference's ``repro.launch.serve``, plus
``--device``: the default runs on the card (and fails without CUDA);
``--device cpu`` runs the plain PyTorch path on the host (use a ``@smoke``
arch there).  Every decoder of the port serves: the dense and MoE ones,
the Zamba2 hybrid and xLSTM, e.g.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-2.7b@smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m

Weights are random, drawn on the device from a ``torch.Generator`` seeded
with 0; prompts come from ``np.random.default_rng(0)`` as in the
reference.  The last line is the paper's reordering of the decode step
at ``--max-batch`` (``ServingEngine.analyse_decode_schedule``), as the
reference prints it.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving import Request, ServingEngine


def make_requests(cfg, n: int, max_new: int) -> List[Request]:
    """The reference launcher's traffic: ``n`` prompts of 4–23 tokens below
    id ``min(500, vocab)``, ``max_new`` new tokens each."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, min(500, cfg.vocab_size),
                                        rng.integers(4, 24))
                    .astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


def build_engine(arch: str, *, max_batch: int, cache_len: int,
                 device=None) -> ServingEngine:
    """Config, random parameters on ``device`` (None: the card) and the
    engine over them."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return ServingEngine(cfg, params, max_batch=max_batch,
                         cache_len=cache_len, device=dev)


def main(argv: Optional[List[str]] = None) -> ServingEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b@smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain path)")
    args = ap.parse_args(argv)

    engine = build_engine(args.arch, max_batch=args.max_batch,
                          cache_len=args.cache_len, device=args.device)
    reqs = make_requests(engine.cfg, args.requests, args.max_new)
    results = engine.serve(reqs)
    for r in results:
        print(f"req {r.rid}: prefill {r.prefill_ms:.0f}ms "
              f"decode {r.decode_ms:.0f}ms tokens={r.tokens}")
    print(f"\narena peak {engine.stats['arena_peak_bytes']/1e6:.1f} MB "
          f"(static {engine.stats['static_bytes']/1e6:.1f} MB) on "
          f"{engine.device}")
    print(engine.analyse_decode_schedule(args.max_batch))
    return engine


if __name__ == "__main__":
    main()
