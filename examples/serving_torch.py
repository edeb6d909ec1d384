"""Serving example on the PyTorch port: prefill + batched greedy decode
with KV caches, on a GPU.

The twin of ``examples/serving.py`` on ``repro_torch``: a reduced
qwen3-14b-family model (QK norm, GQA) prefills a batch of prompts and
greedy-decodes continuations through ``greedy_generate``; then the
sliding-window cache (the sub-quadratic long-context path) prefills the
same prompts into a ring of ``window`` rows and takes one windowed decode
step.

  PYTHONPATH=src python examples/serving_torch.py                # on cuda
  PYTHONPATH=src python examples/serving_torch.py --device cpu
"""
import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import build_serve_step, greedy_generate

ARCH, B, S, N_NEW, WINDOW = "qwen3_14b", 4, 32, 16, 16


def run(device=None, params: Optional[Dict[str, torch.Tensor]] = None,
        prompts: Optional[np.ndarray] = None) -> Dict[str, object]:
    """Greedy-decode ``N_NEW`` tokens for each of ``B`` prompts of ``S``
    tokens, then one windowed decode step.  ``params`` (default: the
    model's init from seed 0) and ``prompts`` (default: a numpy draw,
    seed 1) may be given, as the tests give the reference's.  Returns
    ``{"tokens" (B, N_NEW), "window_cache_shape", "window_next" (B,),
    "seconds"}``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    params = {k: v.to(dev) for k, v in params.items()}
    if prompts is None:
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                    (B, S))
    tokens = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    t0 = time.perf_counter()
    out = greedy_generate(model, params, {"tokens": tokens}, n_steps=N_NEW)
    out = out.cpu()                               # waits for the device
    seconds = time.perf_counter() - t0

    # sliding-window variant (window smaller than the prompt)
    model_w = build_model(cfg, decode_window=WINDOW)
    with torch.inference_mode():
        logits, caches = model_w.prefill(params, {"tokens": tokens})
        shape = tuple(caches[0]["k"].shape)
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
        nxt, _ = build_serve_step(model_w)(params, caches, tok, S)
    return {"tokens": out, "window_cache_shape": shape,
            "window_next": nxt[:, 0].cpu(), "seconds": seconds,
            "prompts": np.asarray(prompts), "arch": cfg.name}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    dt = res["seconds"]
    print(f"arch={res['arch']}  batch={B}  prompt={S} tokens  "
          f"generated={N_NEW} tokens in {dt:.2f}s ({B * N_NEW / dt:.1f} "
          f"tok/s, device {resolve_device(args.device)})")
    for i in range(B):
        print(f"  req{i}: prompt[-4:]={res['prompts'][i, -4:].tolist()} "
              f"-> {res['tokens'][i].tolist()}")
    print(f"\nsliding-window prefill: window={WINDOW}, cache leaf shape "
          f"{res['window_cache_shape']} (ring buffer, vs full {S})")
    print(f"one windowed decode step ok; next tokens "
          f"{res['window_next'].tolist()}")
    return res


if __name__ == "__main__":
    main()
