"""Serving decode benchmark: KV-cache autoregressive generation throughput
for the llama family (models/generate.py) — MHA vs GQA vs MQA caches.

The whole generation (batched prefill + n_new decode steps) is ONE jitted
scan, i.e. one device dispatch per call. Warmup compiles each (net, shape)
before timing; every timing is closed by block_until_ready; repeats report
median + spread. Prints one JSON line per config, naming the device and
the card's power limit:

    python bench_llama_decode.py                                # on a GPU
    JAX_PLATFORMS=cpu python bench_llama_decode.py --tiny       # smoke

Without ``--tiny`` it refuses to run without a GPU; the ``--tiny`` smoke
runs anywhere and its lines say which platform they came from.

The GQA rows quantify the serving saving this family exists for: the
per-block cache is [B, Hkv, T, hd] — kv_heads/heads of the MHA cache
bytes — and every decode step streams the whole cache through the
attention reads, so cache bytes ARE the decode-bandwidth bound at long T.
"""

import argparse
import json
import statistics
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="CPU smoke shapes")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax

    from tinynn_autograd_tpu.models import build_tiny_llama, generate
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.device import describe, require_gpu
    from tinynn_autograd_tpu.utils.seeder import random_seed

    device = describe() if args.tiny else require_gpu()
    enable_compile_cache()

    if args.tiny:
        vocab, dim, heads, depth = 32, 64, 4, 2
        batch, t0, n_new = 2, 8, 32
        kv_sweep = [4, 2, 1]
    else:
        vocab, dim, heads, depth = 256, 512, 8, 4
        batch, t0, n_new = 8, 32, 512
        kv_sweep = [8, 2, 1]   # MHA, GQA 4x, MQA 8x

    rng = np.random.RandomState(0)
    prompt = rng.randint(0, vocab, (batch, t0))

    for kv in kv_sweep:
        random_seed(0)
        net = build_tiny_llama(vocab=vocab, dim=dim, heads=heads,
                               kv_heads=kv, depth=depth)
        net.init((batch, t0))
        # warmup: compiles the prefill+decode scan for this shape
        out = jax.block_until_ready(generate(net, prompt, n_new))
        assert out.shape == (batch, t0 + n_new)
        rates = []
        for _ in range(args.repeats):
            t_start = time.perf_counter()
            jax.block_until_ready(generate(net, prompt, n_new))
            dt = time.perf_counter() - t_start
            rates.append(batch * n_new / dt)
        med = statistics.median(rates)
        hd = dim // heads
        cache_mb = (2 * depth * batch * kv * (t0 + n_new) * hd * 4
                    / 1024 / 1024)
        rec = {
            "metric": "llama_decode_tokens_per_sec_kv%d" % kv,
            "value": med,
            "unit": "tokens/s (batch %d, %d blocks, dim %d, %d q heads, "
                    "%d kv heads, %d new tokens, one-dispatch scan)"
                    % (batch, depth, dim, heads, kv, n_new),
            "spread_pct": 100 * (max(rates) - min(rates)) / med,
            "kv_cache_mb": cache_mb}
        rec.update(device)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
