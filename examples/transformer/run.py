"""Causal language modeling demo: a tiny decoder-only transformer trained
next-token on a synthetic deterministic grammar, end-to-end on the tape
(hand-VJP attention — no jax.grad anywhere). Usage::

    python examples/transformer/run.py --steps 200
    JAX_PLATFORMS=cpu python examples/transformer/run.py   # force CPU
    python examples/transformer/run.py --model llama --top_p 0.9 \
        --temperature 0.8   # llama family (RMSNorm+RoPE+GQA+SwiGLU),
                            # nucleus-sampled decode alongside greedy
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seq_len", type=int, default=16)
    parser.add_argument("--vocab", type=int, default=17)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each block (activation memory "
                             "O(1) in depth; one extra forward in bwd)")
    parser.add_argument("--model", choices=("classic", "llama"),
                        default="classic",
                        help="classic: LayerNorm + learned positions + "
                             "GELU MLP; llama: RMSNorm + RoPE + "
                             "grouped-query attention + SwiGLU")
    parser.add_argument("--kv_heads", type=int, default=2,
                        help="llama GQA kv heads (< heads shrinks the "
                             "decode KV cache)")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="sampled decode demo temperature (0 = skip)")
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--attn_window", type=int, default=None,
                        help="sliding-window (causal local) attention "
                             "span; None = full causal")
    args = parser.parse_args()

    import numpy as np

    from tinynn_autograd_tpu.core.tensor import Tensor
    from tinynn_autograd_tpu.models import build_tiny_llama, build_tiny_lm
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import Adam
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.seeder import random_seed

    enable_compile_cache()
    random_seed(args.seed)
    V, T = args.vocab, args.seq_len
    if args.model == "llama":
        net = build_tiny_llama(vocab=V, dim=64, heads=4,
                               kv_heads=args.kv_heads, depth=2,
                               remat=args.remat,
                               attn_window=args.attn_window)
    else:
        if args.attn_window is not None:
            parser.error("--attn_window is llama-only in this demo")
        net = build_tiny_lm(vocab=V, seq_len=T, dim=64, heads=4, depth=2,
                            remat=args.remat)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(args.lr))

    # synthetic deterministic grammar: x_{t+1} = (3*x_t + 1) mod V, random
    # start token — a causal model can learn it exactly (perplexity -> 1)
    rng = np.random.RandomState(args.seed)

    def sample(n):
        seq = np.empty((n, T + 1), np.int64)
        seq[:, 0] = rng.randint(0, V, n)
        for t in range(T):
            seq[:, t + 1] = (3 * seq[:, t] + 1) % V
        return seq[:, :-1], seq[:, 1:]

    loss_fn = model.loss
    eye = np.eye(V, dtype=np.float32)
    for step in range(args.steps):
        x, targets = sample(args.batch)
        # per-position CE: flatten [B, T, V] logits against [B*T] targets
        logits = model.forward(Tensor(x)).reshape((args.batch * T, V))
        model.zero_grad()
        loss_t = loss_fn.loss(logits, Tensor(eye[targets.reshape(-1)]))
        loss_t.backward()
        model.step()
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            ppl = float(np.exp(float(loss_t.data)))
            print("step %4d  loss %.4f  perplexity %.3f"
                  % (step, float(loss_t.data), ppl))

    # greedy generation from each start token: must follow the grammar
    x, _ = sample(4)
    logits = model.forward(Tensor(x)).numpy()
    pred = logits.argmax(-1)
    want = (3 * x + 1) % V
    acc = (pred == want).mean()
    print("greedy next-token accuracy on the grammar: %.3f" % acc)

    # KV-cache incremental decoding (models.generate): one jitted scan,
    # single-token steps — must continue the grammar from a short prompt
    from tinynn_autograd_tpu.models import generate

    prompt = x[:2, :2]
    out = np.asarray(generate(model.net, prompt, n_new=T - 2))
    follow = (3 * out[:, :-1] + 1) % V
    kv_acc = (out[:, 1:] == follow).mean()
    print("kv-cache decode grammar-follow accuracy: %.3f" % kv_acc)

    if args.temperature > 0:
        import jax

        out = np.asarray(generate(
            model.net, prompt, n_new=T - 2, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p,
            rng=jax.random.PRNGKey(args.seed)))
        follow = (3 * out[:, :-1] + 1) % V
        s_acc = (out[:, 1:] == follow).mean()
        print("sampled decode (temp %.2f, top_k %s, top_p %s) "
              "grammar-follow accuracy: %.3f"
              % (args.temperature, args.top_k, args.top_p, s_acc))


if __name__ == "__main__":
    main()
