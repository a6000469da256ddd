"""Quickstart of the PyTorch port: parts 2 and 3 of examples/quickstart.py
(part 1, the CXL-SSD simulator, is the JAX package's alone), on the card.

  PYTHONPATH=src python examples/quickstart_torch.py                 # the CUDA kernels
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # their plain versions

2. a model from the assigned pool — one training step
3. the SkyByte tiering runtime — paged+logged decode equals dense decode
   (on the CPU token for token; on the card each token within bf16 noise,
   NEAR_TIE, of the dense decode's max logit: the kernels round apart from
   the dense path, which can flip a near tie)
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import OptimConfig, get_reduced
from repro_torch.core.tiering import TieredKVConfig
from repro_torch.launch.serve import baseline_serve, dense_decode
from repro_torch.launch.steps import build_train_step, make_train_state
from repro_torch.models.api import ModelSpec
from repro_torch.serving.engine import Request, TieredEngine

NEAR_TIE = 2e-2  # bf16 noise on the reduced model's logits of ~0.3 (tests/test_torch_gpu.py)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== 2. one training step (smollm-135m, reduced) ===")
    spec = ModelSpec(get_reduced("smollm-135m"))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(spec, gen, device=dev)
    step = build_train_step(spec, OptimConfig(lr=1e-3), accum_steps=2)
    batch = {"tokens": torch.randint(0, spec.cfg.vocab, (4, 64), generator=gen, dtype=torch.int32, device=dev)}
    state, metrics = step(state, batch)
    print(f"loss={float(metrics['loss']):.4f} grad_norm={float(metrics['grad_norm']):.3f}")

    print("=== 3. tiered paged-KV serving (SkyByte runtime) ===")
    spec = ModelSpec(get_reduced("qwen3-1.7b"))
    params = spec.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    kv = TieredKVConfig(page_size=8, n_hbm_pages=12, max_requests=2, max_pages_per_req=8, log_slots=32, batch=2,
                        promote_pages_per_step=2)
    eng = TieredEngine(spec, params, kv, device=dev)
    prompts = {0: list(range(5, 25)), 1: list(range(30, 45))}
    for rid, prompt in prompts.items():
        eng.add_request(Request(rid=rid, prompt=prompt, max_new_tokens=12))
    stats = eng.run(200)
    print(f"decoded {stats.decoded_tokens} tokens; ctx-switches(parks)={stats.parks} "
          f"promoted={stats.promoted_pages} compactions={stats.compactions}")
    dense, _ = baseline_serve(spec, params, prompts, 12, device=dev)
    equal = sum(a == b for rid in prompts for a, b in zip(eng.requests[rid].out, dense[rid]))
    total = sum(len(dense[rid]) for rid in prompts)
    gap = max(max(dense_decode(spec, params, p, 12, forced=eng.requests[rid].out, device=dev)[1])
              for rid, p in prompts.items())
    print(f"tiered decode: {equal} of {total} tokens equal to dense decode; each within {gap:.4f} of the dense "
          f"decode's max logit (limit {NEAR_TIE})")
    if gap > NEAR_TIE:
        raise SystemExit("tiered decode is not dense decode")
    print("ok")


if __name__ == "__main__":
    main()
