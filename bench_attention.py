"""Flash-attention kernels against the XLA twin on the GPU.

For each attention shape the benchmark cells run (llama seq 1024 GQA, the
seq-2048 causal transformer with and without dropout / window 512, the
seq-128 classifier) it checks the Triton kernels against the exact-math
XLA twin, forward and backward, and times both: median of ``--repeats``
calls of a jitted forward and forward+backward, each closed by
``block_until_ready`` after an untimed compile call. ``--sweep`` also
times alternative tile configurations of the kernels.

Usage: python bench_attention.py [--repeats N] [--sweep]
Prints one JSON line per (shape, impl or tiles, direction), each naming
the device and the card's power limit. Refuses to run without a GPU.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, ".")

# (name, B, H, Hkv, T, d, kwargs)
SHAPES = [
    ("llama_seq1024_gqa", 4, 8, 2, 1024, 64, dict(causal=True)),
    ("causal_seq2048", 4, 8, 8, 2048, 64, dict(causal=True)),
    ("causal_seq2048_dropout", 4, 8, 8, 2048, 64,
     dict(causal=True, dropout_rate=0.1, dropout_seed=7)),
    ("causal_seq2048_window512", 4, 8, 8, 2048, 64,
     dict(causal=True, window=512)),
    ("cls_seq128", 32, 8, 8, 128, 32, dict(causal=False)),
    ("causal_seq512", 4, 8, 8, 512, 64, dict(causal=True)),
    ("causal_seq4096", 2, 8, 8, 4096, 64, dict(causal=True)),
]

SWEEP_SHAPES = ("llama_seq1024_gqa", "causal_seq2048", "cls_seq128")

# (bq, bk, num_warps, num_stages) candidates for --sweep
FWD_TILES = [(64, 64, 4, 3), (128, 64, 4, 3), (128, 64, 8, 3),
             (64, 32, 4, 3), (32, 64, 4, 3), (64, 64, 4, 2),
             (128, 32, 8, 3), (64, 128, 8, 2), (128, 128, 8, 2)]
BWD_TILES = [(64, 64, 4, 2), (32, 64, 4, 2), (64, 32, 4, 2),
             (32, 32, 4, 2), (64, 64, 8, 2), (128, 64, 8, 2),
             (64, 64, 4, 3), (32, 128, 4, 2), (128, 32, 8, 2),
             (32, 32, 2, 2)]


def median_us(fn, repeats):
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def sweep_point(emit, metric, tiles, measure):
    """Emit one measurement: ``measure()``'s number (or dict of fields).
    A kernel the GPU compiler refuses (too much shared memory, too many
    registers) is reported in the line's ``error``, not fatal, so one bad
    tile configuration does not hide the others."""
    rec = {"metric": metric}
    if tiles is not None:
        rec["tiles"] = list(tiles)
    try:
        out = measure()
        rec.update(out if isinstance(out, dict) else {"value": out})
    except Exception as e:  # noqa: BLE001 — reported, the sweep goes on
        rec["error"] = "%s: %s" % (type(e).__name__, str(e)[:400])
    emit(rec)


def main():
    import jax
    import jax.numpy as jnp

    from tinynn_autograd_tpu.ops import attention
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.device import require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the FWD_TILES / BWD_TILES candidates")
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()

    def emit(rec):
        rec.update(device)
        print(json.dumps(rec), flush=True)

    for name, b, h, hkv, t, d, kw in SHAPES:
        rng = np.random.RandomState(0)
        q, do = (jnp.asarray(rng.randn(b, h, t, d), jnp.float32)
                 for _ in range(2))
        k, v = (jnp.asarray(rng.randn(b, hkv, t, d), jnp.float32)
                for _ in range(2))

        def fns(impl):
            def fwd(q, k, v):
                return attention.mha_fwd(q, k, v, impl=impl, **kw)

            def fwd_bwd(q, k, v, do):
                o, lse = attention.mha_fwd(q, k, v, impl=impl, **kw)
                return attention.mha_bwd(q, k, v, o, lse, do, impl=impl,
                                         **kw)
            return jax.jit(fwd), jax.jit(fwd_bwd)

        fx, fbx = fns("xla")
        fp, fbp = fns("pallas")
        ref_o, ref_g = fx(q, k, v), fbx(q, k, v, do)

        def rel(a, r):
            a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
            return float(np.max(np.abs(a - r)) / np.max(np.abs(r)))

        def parity():
            got_o, got_g = fp(q, k, v), fbp(q, k, v, do)
            return {"rel_err_fwd": max(map(rel, got_o, ref_o)),
                    "rel_err_bwd": max(map(rel, got_g, ref_g)),
                    "tol": 1e-4,
                    "tol_reason": "f32: TF32x3 dots (kernel) vs HIGHEST "
                                  "(twin), summation order"}

        sweep_point(emit, "attn_parity_" + name, None, parity)
        for impl, f, fb in (("xla", fx, fbx), ("pallas", fp, fbp)):
            sweep_point(emit, "attn_fwd_%s_%s_us" % (impl, name), None,
                        lambda: median_us(lambda: f(q, k, v),
                                          args.repeats))
            sweep_point(emit, "attn_fwdbwd_%s_%s_us" % (impl, name), None,
                        lambda: median_us(lambda: fb(q, k, v, do),
                                          args.repeats))
        if not args.sweep or name not in SWEEP_SHAPES:
            continue
        orig = (attention._fwd_tiles, attention._bwd_tiles)
        try:
            for tiles in FWD_TILES:
                attention._fwd_tiles = lambda *a, _t=tiles: _t
                f, _ = fns("pallas")
                sweep_point(emit, "attn_fwd_tiles_" + name, tiles,
                            lambda: median_us(lambda: f(q, k, v),
                                              args.repeats))
            attention._fwd_tiles = orig[0]
            for tiles in BWD_TILES:
                attention._bwd_tiles = lambda *a, _t=tiles: _t
                _, fb = fns("pallas")
                sweep_point(emit, "attn_fwdbwd_bwdtiles_" + name, tiles,
                            lambda: median_us(lambda: fb(q, k, v, do),
                                              args.repeats))
        finally:
            attention._fwd_tiles, attention._bwd_tiles = orig


if __name__ == "__main__":
    main()
