"""Serving from the command line:

    python -m repro_torch.launch.serve --arch granite-3-2b [--device cpu]
    python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu

Spins up the continuous-batching engine on a reduced config and runs a
batch of synthetic prompts through it, on the CUDA card unless
``--device cpu`` is given.  Every token architecture is served (dense,
MoE, MLA, Mamba, hybrid and NFFT stacks); the frontend and encoder-only
architectures (hubert-xlarge, paligemma-3b) are refused, as the JAX
package's command line refuses them.  As there, ``--reduced`` is always
on (a store_true flag whose default is True).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.frontend != "none" or cfg.encoder_only:
        raise SystemExit(f"{cfg.name}: engine demo serves token-LM archs")

    model = M.init_params(cfg, args.seed, device=args.device)
    engine = ServeEngine(cfg, model, slots=args.slots, max_seq=args.max_seq,
                         device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 17))
        reqs.append(Request(
            uid=i, tokens=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=args.max_new))
        engine.submit(reqs[-1])

    t0 = time.perf_counter()
    engine.run_until_drained()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    if not all(r.done for r in reqs):
        raise SystemExit("engine stopped with requests still running")
    print(f"served {len(reqs)} requests / {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, slots={args.slots}, "
          f"device={engine.device}, arch={cfg.name})")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt_len={len(r.tokens)} -> {r.output[:8]}…")


if __name__ == "__main__":
    main()
