#!/usr/bin/env python3
"""``--matching_precision high`` against its K chunk: ``python3 measure_precision.py``.

Run from the root of a checkout on a machine with a CUDA card. At the
reference batch 5000 (unit critic features, d 32768, lam 500, 500
iterations, the grid tier) it matches under ``highest`` once, then under
``high`` for each ``HIGH_K_CHUNK`` in ``CHUNKS`` (32768: one pass over the
whole K) and prints per chunk: one cost matrix's largest error against
float64 (a (2500, 32768) half against another), the matched features',
``dist``'s and entropy's deltas against ``highest``, and ms a match; then
``highest``'s and ``default``'s. What ``ops/costs.py``'s chunk rests on.
The last line is one JSON object with every row and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import sys

CHUNKS = (32768, 8192, 4096, 2048, 1024, 512)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("measure_precision: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import LAM, ITERS, BATCH, card_line, cuda_ms, unit_features
    from otgan_tpu_torch.kernels.build import build_all
    from otgan_tpu_torch.ops import costs
    from otgan_tpu_torch.ops.matching import calc_distance, match_two_batch

    card = card_line()
    print(card, flush=True)
    build_all()
    gen = torch.Generator(device="cuda").manual_seed(13)
    fa, fb = unit_features(gen, BATCH, 32768), unit_features(gen, BATCH, 32768)
    half_a, half_b = fa[:BATCH // 2], fb[:BATCH // 2]
    exact = 1.0 - half_a.double() @ half_b.double().T

    def match(p):
        return match_two_batch(fa, fb, LAM, ITERS, use_pallas=True, precision=p)

    def row(p):
        err = float((costs.cosine_cost(half_a, half_b, p).double() - exact).abs().max())
        m = match(p)
        return {"cost_vs_float64": err,
                "features_vs_highest": max(float((a - b).abs().max())
                                           for a, b in zip(m[:4], ref[:4])),
                "dist_vs_highest": abs(float(calc_distance(fa, fb, m)) - ref_dist),
                "entropy_vs_highest": abs(float(m.entropy) - float(ref.entropy)),
                "match_ms": cuda_ms(lambda: match(p), reps=3)}

    ref = match("highest")
    ref_dist = float(calc_distance(fa, fb, ref))
    keep = costs.HIGH_K_CHUNK
    res = {"card": card, "high": {}}
    try:
        for chunk in CHUNKS:
            costs.HIGH_K_CHUNK = chunk
            res["high"][chunk] = row("high")
            print(f"high, K in chunks of {chunk}: {json.dumps(res['high'][chunk])}", flush=True)
    finally:
        costs.HIGH_K_CHUNK = keep
    for p in ("highest", "default"):
        res[p] = row(p)
        print(f"{p}: {json.dumps(res[p])}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
