"""Autoregressive decoding with a KV cache for the causal-LM family.

The serving-side counterpart of ``build_tiny_lm``: instead of re-running
the full [B, T] forward per emitted token (O(T^2) work per token, O(T^3)
per sequence), each step feeds ONE token through the blocks, appends its
per-block K/V to a static-shape cache, and attends the single query row
against the cache — the standard incremental-decoding scheme. The whole
generation loop is ONE ``lax.scan`` under ``jax.jit`` (static shapes,
positions masked by the running length), so the chip sees a single
dispatch per ``generate`` call.

Inference-only: this path reads the layers' parameters but never builds
tape state (no gradients through generation). At the default f32 serving
precision, numerics match the f32 training forward exactly — the parity
test decodes token-for-token against repeated full ``net.forward``
argmax. Serving precision is a separate knob from training precision:
``dtype=jnp.bfloat16`` runs the matmuls and holds the KV caches in bf16
(norm/softmax/sampling cores stay f32), and nets TRAINED with
``compute_dtype=`` mixed precision decode from their f32 master params
(so two same-seed nets, one bf16-trained and one f32, generate
identically at the default serving precision). No reference counterpart
(the reference has no sequence models or serving path).
"""

import contextlib
import functools

import numpy as np

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.nn.layers import (
    Dense, Embedding, LlamaBlock, PositionalEmbedding, Remat, RMSNorm,
    TransformerBlock,
)

_NEG_INF = -1e30

# param keys that feed matmuls (cast to the serving dtype); norm
# scales/shifts stay f32 (the norm cores always run in f32)
_MATMUL_KEYS = frozenset(
    ["wq", "wk", "wv", "wo", "w1", "w2", "w3", "b1", "b2", "w", "b"])


def _serving_casts(cd):
    """(cast, up) helpers for a serving dtype ``cd`` (None = f32 path,
    both identity — the default path is byte-identical to before the
    dtype option existed). ``cast`` moves matmul operands / the residual
    stream / the KV caches into ``cd``; ``up`` lifts into f32 for the
    norm and softmax cores (mirrors nn.layers._to_dtype's policy)."""
    if cd is None:
        ident = lambda x: x  # noqa: E731
        return ident, ident
    cast = lambda x: x.astype(cd)            # noqa: E731
    up = lambda x: x.astype(jnp.float32)     # noqa: E731
    return cast, up


def _cast_params(params, cd):
    """Cast the matmul parameters (and the embedding table) of an
    extracted param pytree to the serving dtype; norm params stay f32."""
    if cd is None:
        return params
    out = dict(params)
    out["emb"] = params["emb"].astype(cd)
    if "pos" in params:
        out["pos"] = params["pos"].astype(cd)
    out["head"] = {k: v.astype(cd) for k, v in params["head"].items()}
    out["blocks"] = [
        {k: (v.astype(cd) if k in _MATMUL_KEYS else v)
         for k, v in bp.items()}
        for bp in params["blocks"]]
    return out


def _gelu(x):
    c = np.sqrt(2.0 / np.pi).astype(np.float32)
    return 0.5 * x * (1.0 + jnp.tanh(c * (x + 0.044715 * x ** 3)))


def _ln(x, g, b, eps):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / jnp.sqrt(var + eps) * g + b


def _rms(x, g, eps):
    r = jax.lax.rsqrt((x * x).mean(-1, keepdims=True) + eps)
    return x * r * g


def _extract(net):
    """Pull the concrete param arrays of a build_tiny_lm-style net:
    Embedding, PositionalEmbedding, TransformerBlock*, Dense head."""
    emb = pos = head = None
    blocks = []
    windows = []
    heads = eps = None
    for layer in net.layers:
        if isinstance(layer, Remat):
            # training-only wrapper; decode reads the inner layer
            layer = layer.inner
        if isinstance(layer, Embedding):
            emb = layer.params["w"].data
        elif isinstance(layer, PositionalEmbedding):
            pos = layer.params["pos"].data
        elif isinstance(layer, TransformerBlock):
            if not layer.causal:
                raise ValueError(
                    "generate() needs causal TransformerBlocks (an acausal "
                    "block's output at position t depends on the future)")
            if heads is not None and (heads, eps) != (layer.num_heads,
                                                      layer.eps):
                raise ValueError(
                    "generate() needs blocks with UNIFORM heads/eps "
                    "(only attn_window may vary per block)")
            heads, eps = layer.num_heads, layer.eps
            windows.append(layer.attn_window)
            blocks.append({k: v.data for k, v in layer.params.items()})
        elif isinstance(layer, Dense):
            head = {k: v.data for k, v in layer.params.items()}
        else:
            raise ValueError("generate() does not support layer %r"
                             % layer.name)
    if emb is None or pos is None or head is None or not blocks:
        raise ValueError("net is not a causal LM "
                         "(Embedding + PositionalEmbedding + blocks + head)")
    return emb, pos, blocks, head, heads, eps, tuple(windows)


def _extract_llama(net):
    """Pull the concrete param arrays of a build_tiny_llama-style net:
    Embedding, LlamaBlock*, RMSNorm, Dense head."""
    emb = head = norm = None
    blocks = []
    windows = []
    meta = None
    for layer in net.layers:
        if isinstance(layer, Remat):
            layer = layer.inner
        if isinstance(layer, Embedding):
            emb = layer.params["w"].data
        elif isinstance(layer, LlamaBlock):
            if not layer.causal:
                raise ValueError("generate() needs causal LlamaBlocks")
            lm = (layer.num_heads, layer.num_kv_heads, layer.head_dim,
                  layer.eps, layer.rope_base)
            if meta is not None and meta != lm:
                raise ValueError(
                    "generate() needs LlamaBlocks with UNIFORM heads/"
                    "kv_heads/eps/rope_base (only attn_window may vary "
                    "per block)")
            meta = lm
            windows.append(layer.attn_window)
            blocks.append({k: v.data for k, v in layer.params.items()})
        elif isinstance(layer, RMSNorm):
            norm = layer.params["g"].data
        elif isinstance(layer, Dense):
            head = {k: v.data for k, v in layer.params.items()}
        else:
            raise ValueError("generate() does not support layer %r"
                             % layer.name)
    if emb is None or head is None or norm is None or not blocks:
        raise ValueError("net is not a llama-family LM "
                         "(Embedding + LlamaBlocks + RMSNorm + head)")
    return emb, blocks, norm, head, meta, tuple(windows)


def _rope_one(x, t, base):
    """Rotate ONE token's heads [..., hd] to absolute position ``t``
    (traced scalar) — the decode-time counterpart of ops.rope_'s
    half-split convention."""
    hd = x.shape[-1]
    half = hd // 2
    inv_freq = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = t.astype(jnp.float32) * inv_freq
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           axis=-1)


def _rope_batch(x, base):
    """Rotate [B, H, T, hd] heads to positions 0..T-1 (prefill-time
    counterpart of ops.rope_, same half-split convention)."""
    t, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    inv_freq = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = jnp.arange(t, dtype=jnp.float32)[:, None] * inv_freq[None, :]
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           axis=-1)


def _banded_tril(t0, window):
    from tinynn_autograd_tpu.ops.attention import band_mask

    return jnp.asarray(band_mask(t0, window))


def _prefill_classic(blocks, emb, pos, head, heads, eps, prompt, t_max,
                     windows, cd=None):
    """Batched prefill — the serving-standard prefill/decode split: ONE
    fused forward over the whole prompt [B, T0] computes every block's
    K/V for all prompt positions (written into the static-size caches)
    and the last position's logits, instead of T0 sequential single-token
    steps. Exact same math as the cached step, batched over positions.

    ``cd``: serving dtype (e.g. bf16) — matmul operands, the residual
    stream, and the caches run/live in ``cd``; norms and softmax in f32
    (score/ctx einsums take the bf16 operands natively and accumulate f32
    via preferred_element_type)."""
    cast, up = _serving_casts(cd)
    b, t0 = prompt.shape
    d = emb.shape[1]
    hd = d // heads
    x = emb[prompt] + pos[:, :t0]
    masks = {w: _banded_tril(t0, w) for w in set(windows)}
    caches = []
    for bp, window in zip(blocks, windows):
        mask = masks[window]
        xn = cast(_ln(up(x), bp["g1"], bp["be1"], eps))
        q = (xn @ bp["wq"]).reshape(b, t0, heads, hd).transpose(0, 2, 1, 3)
        k = (xn @ bp["wk"]).reshape(b, t0, heads, hd).transpose(0, 2, 1, 3)
        v = (xn @ bp["wv"]).reshape(b, t0, heads, hd).transpose(0, 2, 1, 3)
        pad = [(0, 0), (0, 0), (0, t_max - t0), (0, 0)]
        caches.append((jnp.pad(k, pad), jnp.pad(v, pad)))
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                       preferred_element_type=jnp.float32) / np.sqrt(hd)
        s = jnp.where(mask, s, _NEG_INF)
        p = jax.nn.softmax(s, axis=-1)
        ctx = jnp.einsum("bhqk,bhkd->bhqd", p, v,
                         preferred_element_type=jnp.float32)
        x = x + cast(ctx.transpose(0, 2, 1, 3).reshape(b, t0, d)) @ bp["wo"]
        yn = cast(_ln(up(x), bp["g2"], bp["be2"], eps))
        x = x + cast(_gelu(yn @ bp["w1"] + bp["b1"])) @ bp["w2"] + bp["b2"]
    return up(x[:, -1] @ head["w"] + head["b"]), caches


def _prefill_llama(blocks, emb, normg, head, hkv, group, hd, eps, base,
                   prompt, t_max, windows, cd=None):
    """Batched llama prefill: one fused pass filling the GQA caches
    (held at Hkv heads) for all prompt positions. ``cd``: serving dtype —
    see _prefill_classic; the GQA caches are stored POST-RoPE in ``cd``
    (half the HBM at bf16, the headline serving saving on top of GQA)."""
    cast, up = _serving_casts(cd)
    b, t0 = prompt.shape
    d = emb.shape[1]
    h = hkv * group
    x = emb[prompt]
    masks = {w: _banded_tril(t0, w) for w in set(windows)}
    caches = []
    for bp, window in zip(blocks, windows):
        mask = masks[window]
        xn = cast(_rms(up(x), bp["g1"], eps))
        q = (xn @ bp["wq"]).reshape(b, t0, h, hd).transpose(0, 2, 1, 3)
        k = (xn @ bp["wk"]).reshape(b, t0, hkv, hd).transpose(0, 2, 1, 3)
        v = (xn @ bp["wv"]).reshape(b, t0, hkv, hd).transpose(0, 2, 1, 3)
        q, k = cast(_rope_batch(q, base)), cast(_rope_batch(k, base))
        pad = [(0, 0), (0, 0), (0, t_max - t0), (0, 0)]
        caches.append((jnp.pad(k, pad), jnp.pad(v, pad)))
        qg = q.reshape(b, hkv, group, t0, hd)
        s = jnp.einsum("bkgqd,bkcd->bkgqc", qg, k,
                       preferred_element_type=jnp.float32) / np.sqrt(hd)
        s = jnp.where(mask, s, _NEG_INF)
        p = jax.nn.softmax(s, axis=-1)
        ctx = jnp.einsum("bkgqc,bkcd->bkgqd", p, v,
                         preferred_element_type=jnp.float32)
        ctx = cast(ctx.reshape(b, h, t0, hd).transpose(0, 2, 1, 3))
        x = x + ctx.reshape(b, t0, d) @ bp["wo"]
        yn = cast(_rms(up(x), bp["g2"], eps))
        x = x + (jax.nn.silu(yn @ bp["w1"]) * (yn @ bp["w3"])) @ bp["w2"]
    return up(cast(_rms(up(x[:, -1]), normg, eps))
              @ head["w"] + head["b"]), caches


def _block_step(bp, x, cache_k, cache_v, t, heads, eps, t_max,
                window=None, cd=None):
    """One transformer block on ONE token x [B, D] at position t, reading
    and appending the block's KV cache [B, H, T_max, hd]. ``window``:
    sliding-window attention — only cache rows in (t - window, t] are
    visible. ``cd``: serving dtype (see _prefill_classic)."""
    cast, up = _serving_casts(cd)
    b, d = x.shape
    hd = d // heads
    xn = cast(_ln(up(x), bp["g1"], bp["be1"], eps))
    q = (xn @ bp["wq"]).reshape(b, heads, 1, hd)
    k = (xn @ bp["wk"]).reshape(b, heads, hd)
    v = (xn @ bp["wv"]).reshape(b, heads, hd)
    cache_k = jax.lax.dynamic_update_index_in_dim(cache_k, k, t, axis=2)
    cache_v = jax.lax.dynamic_update_index_in_dim(cache_v, v, t, axis=2)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, cache_k,
                   preferred_element_type=jnp.float32) / np.sqrt(hd)
    pos_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 3)
    vis = pos_ids <= t
    if window is not None:
        vis &= pos_ids > t - window
    s = jnp.where(vis, s, _NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", p, cache_v,
                     preferred_element_type=jnp.float32)
    x = x + cast(ctx.reshape(b, d)) @ bp["wo"]
    yn = cast(_ln(up(x), bp["g2"], bp["be2"], eps))
    x = x + cast(_gelu(yn @ bp["w1"] + bp["b1"])) @ bp["w2"] + bp["b2"]
    return x, cache_k, cache_v


def _llama_block_step(bp, x, cache_k, cache_v, t, hkv, group, hd, eps,
                      base, window=None, cd=None):
    """One LlamaBlock on ONE token x [B, D] at position t, reading and
    appending the block's GQA KV cache [B, Hkv, T_max, hd] — the cache is
    held at Hkv heads (the GQA serving saving); the query's H = Hkv*group
    heads read it grouped. ``cd``: serving dtype — the cache lives in
    ``cd`` (bf16 halves KV HBM on top of the GQA head saving)."""
    cast, up = _serving_casts(cd)
    b, d = x.shape
    xn = cast(_rms(up(x), bp["g1"], eps))
    q = (xn @ bp["wq"]).reshape(b, hkv, group, hd)
    k = (xn @ bp["wk"]).reshape(b, hkv, hd)
    v = (xn @ bp["wv"]).reshape(b, hkv, hd)
    q = cast(_rope_one(q, t, base))
    k = cast(_rope_one(k, t, base))
    cache_k = jax.lax.dynamic_update_index_in_dim(cache_k, k, t, axis=2)
    cache_v = jax.lax.dynamic_update_index_in_dim(cache_v, v, t, axis=2)
    s = jnp.einsum("bkgd,bktd->bkgt", q, cache_k,
                   preferred_element_type=jnp.float32) / np.sqrt(hd)
    pos_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 3)
    vis = pos_ids <= t
    if window is not None:
        vis &= pos_ids > t - window
    s = jnp.where(vis, s, _NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    ctx = jnp.einsum("bkgt,bktd->bkgd", p, cache_v,
                     preferred_element_type=jnp.float32)
    x = x + cast(ctx.reshape(b, d)) @ bp["wo"]
    yn = cast(_rms(up(x), bp["g2"], eps))
    x = x + (jax.nn.silu(yn @ bp["w1"]) * (yn @ bp["w3"])) @ bp["w2"]
    return x, cache_k, cache_v


def _filter_logits(logits, top_k, top_p):
    """Standard sampling filters (static top_k / top_p): mask everything
    below the k-th logit, then everything outside the smallest
    nucleus whose cumulative probability reaches top_p (the max-prob
    token always survives)."""
    if top_k is not None:
        kth = jnp.sort(logits, axis=-1)[..., -int(top_k)][..., None]
        logits = jnp.where(logits < kth, _NEG_INF, logits)
    if top_p is not None:
        srt = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(srt, axis=-1)
        exceeds = jnp.cumsum(probs, axis=-1) - probs >= top_p
        # the max-prob token always survives (top_p <= 0 would otherwise
        # mask every position and degrade to uniform sampling)
        exceeds = exceeds.at[..., 0].set(False)
        min_kept = jnp.min(jnp.where(exceeds, jnp.inf, srt), axis=-1,
                           keepdims=True)
        logits = jnp.where(logits < min_kept, _NEG_INF, logits)
    return logits


def _cfg_dtype(cfg):
    """The serving dtype baked into a static config (None = f32)."""
    name = cfg[8] if len(cfg) > 8 else None
    return None if name is None else jnp.dtype(name)


def _matmul_precision(cfg):
    """Trace-time matmul precision of a decode program: f32 serving states
    HIGHEST, so a GPU does not round the operands to TF32 and the decode
    agrees with the f32 training forward; narrower serving dtypes keep the
    default."""
    if _cfg_dtype(cfg) is None:
        return jax.default_matmul_precision("highest")
    return contextlib.nullcontext()


def _make_token_logits(cfg, params):
    """Single-token step closure over a STATIC config + call-time param
    pytree (shared by the cached decode/beam runners). Logits are always
    returned in f32 (the sampling/softmax core runs in f32 regardless of
    the serving dtype)."""
    (family, b_eff, t0, n_new, t_max, n_blocks, windows, fam) = cfg[:8]
    cd = _cfg_dtype(cfg)
    cast, up = _serving_casts(cd)
    emb, head, blocks = params["emb"], params["head"], params["blocks"]

    def token_logits(tok, t, caches):
        new_caches = []
        if family == "llama":
            hkv, group, hd, eps, base = fam
            x = emb[tok]
            for l in range(n_blocks):
                ck, cv = caches[l]
                x, ck, cv = _llama_block_step(
                    blocks[l], x, ck, cv, t, hkv, group, hd, eps, base,
                    windows[l], cd)
                new_caches.append((ck, cv))
            return (up(cast(_rms(up(x), params["norm"], eps))
                       @ head["w"] + head["b"]),
                    new_caches)
        heads, eps = fam
        x = emb[tok] + params["pos"][0, t]
        for l in range(n_blocks):
            ck, cv = caches[l]
            x, ck, cv = _block_step(blocks[l], x, ck, cv, t, heads, eps,
                                    t_max, windows[l], cd)
            new_caches.append((ck, cv))
        return up(x @ head["w"] + head["b"]), new_caches

    return token_logits


def _run_prefill(cfg, params, prompt):
    (family, b_eff, t0, n_new, t_max, n_blocks, windows, fam) = cfg[:8]
    cd = _cfg_dtype(cfg)
    if family == "llama":
        hkv, group, hd, eps, base = fam
        return _prefill_llama(
            params["blocks"], params["emb"], params["norm"],
            params["head"], hkv, group, hd, eps, base, prompt, t_max,
            windows, cd)
    heads, eps = fam
    return _prefill_classic(
        params["blocks"], params["emb"], params["pos"], params["head"],
        heads, eps, prompt, t_max, windows, cd)


@functools.lru_cache(maxsize=64)
def _decode_fn(cfg, temperature, top_k, top_p, eos_id):
    """Build + jit the batched-prefill + decode-scan program ONCE per
    static config. Parameters, prompt, and the PRNG key are CALL-TIME
    arguments, so repeated generate() calls on the same net shape reuse
    the compiled program (the per-call @jax.jit closure this replaces
    recompiled on every invocation)."""
    b, t0, n_new = cfg[1], cfg[2], cfg[3]

    def pick(logits, key):
        if not temperature:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits = _filter_logits(logits / temperature, top_k, top_p)
        return jax.random.categorical(key, logits, axis=-1).astype(
            jnp.int32)

    def run(params, prompt, key):
        with _matmul_precision(cfg):
            return decode(params, prompt, key)

    def decode(params, prompt, key):
        token_logits = _make_token_logits(cfg, params)
        logits, caches = _run_prefill(cfg, params, prompt)

        def decode_body(carry, i):
            caches, logits, key, done = carry
            key, sub = jax.random.split(key)
            tok = pick(logits, sub)
            if eos_id is not None:
                tok = jnp.where(done, jnp.int32(eos_id), tok)
                done = done | (tok == jnp.int32(eos_id))
            new_logits, caches = token_logits(tok, t0 + i, caches)
            return (caches, new_logits, key, done), tok

        done0 = jnp.zeros((b,), bool)
        (_, _, _, _), toks = jax.lax.scan(
            decode_body, (caches, logits, key, done0), jnp.arange(n_new))
        return toks.T  # [B, n_new]

    return jax.jit(run)


def _extract_any(net, b, t0, n_new, dtype=None):
    """Shared front half of generate/generate_beam: pull params + build
    the hashable static config. ``dtype``: serving precision — matmul
    params/activations/caches in that dtype, norm+softmax cores in f32;
    None decodes in full f32 from the (always-f32) master params, which
    is also the default for nets TRAINED with compute_dtype= mixed
    precision (serving precision is an independent knob)."""
    is_llama = any(isinstance(getattr(lyr, "inner", lyr), LlamaBlock)
                   for lyr in net.layers)
    if is_llama:
        emb, blocks, normg, head, meta, windows = _extract_llama(net)
        h, hkv, hd, eps, base = meta
        t_max = t0 + n_new
        fam = (hkv, h // hkv, hd, float(eps), float(base))
        params = {"emb": emb, "norm": normg, "head": head,
                  "blocks": blocks}
        cfg = ("llama", b, t0, int(n_new), t_max, len(blocks), windows,
               fam, None if dtype is None else jnp.dtype(dtype).name)
    else:
        emb, pos, blocks, head, heads, eps, windows = _extract(net)
        t_max = pos.shape[1]
        if t0 + n_new > t_max:
            raise ValueError(
                "prompt (%d) + n_new (%d) exceeds the positional-embedding "
                "length (%d)" % (t0, n_new, t_max))
        fam = (heads, float(eps))
        params = {"emb": emb, "pos": pos, "head": head, "blocks": blocks}
        cfg = ("classic", b, t0, int(n_new), t_max, len(blocks), windows,
               fam, None if dtype is None else jnp.dtype(dtype).name)
    return cfg, _cast_params(params, _cfg_dtype(cfg))


def generate(net, prompt_ids, n_new, temperature=0.0, rng=None,
             top_k=None, top_p=None, eos_id=None, dtype=None):
    """Decode ``n_new`` tokens after ``prompt_ids`` [B, T0] (int ids).

    Supports both causal-LM families: build_tiny_lm nets (learned
    positions, full-head KV caches) and build_tiny_llama nets (RoPE
    positions, GQA caches held at ``num_kv_heads`` heads). Sliding-window
    blocks mask their visible cache range PER BLOCK (heterogeneous
    local/global stacks decode correctly).

    ``temperature=0`` is greedy argmax; otherwise softmax sampling at the
    given temperature with ``rng`` (a jax PRNG key; required), optionally
    truncated by ``top_k`` (keep the k best logits) and/or ``top_p``
    (nucleus sampling: keep the smallest set reaching cumulative
    probability p) — filters apply after the temperature division, in the
    standard order. Returns int32 [B, T0 + n_new] — the prompt with the
    generated continuation.

    ``eos_id``: once a row emits this token every later position in that
    row repeats it (the standard early-stop protocol under static
    shapes).

    ``dtype``: serving precision (e.g. ``jnp.bfloat16``) — matmul
    weights, activations, and the KV caches run/live in that dtype
    (bf16 halves cache + weight memory and feeds the tensor cores their
    fast input type) while norms, softmax, and sampling stay f32; logits drift
    ~1e-2 relative vs the f32 decode, so greedy argmax can differ on
    near-ties. Default ``None`` decodes in full f32 from the master
    params — including for nets TRAINED with ``compute_dtype=`` mixed
    precision (training compute dtype and serving dtype are independent
    knobs; the masters are always f32).

    The compiled program is CACHED per (net architecture, shapes,
    sampling config, serving dtype): repeated calls pay one dispatch, not
    a recompile; parameter values are call-time arguments, so generating
    from a net that trained further reuses the same program.
    """
    prompt_ids = jnp.asarray(prompt_ids, jnp.int32)
    b, t0 = prompt_ids.shape
    if temperature and rng is None:
        raise ValueError("sampling (temperature > 0) needs rng=PRNGKey")
    cfg, params = _extract_any(net, b, t0, n_new, dtype)
    fn = _decode_fn(cfg, float(temperature),
                    None if top_k is None else int(top_k),
                    None if top_p is None else float(top_p),
                    None if eos_id is None else int(eos_id))
    key = rng if rng is not None else jax.random.PRNGKey(0)
    toks = fn(params, prompt_ids, key)
    return jnp.concatenate([prompt_ids, toks], axis=1)


@functools.lru_cache(maxsize=64)
def _beam_fn(cfg, w, eos_id):
    """Build + jit the beam-search program once per static config (same
    caching contract as _decode_fn)."""
    b, t0, n_new = cfg[1], cfg[2], cfg[3]

    def run(params, prompt):
        with _matmul_precision(cfg):
            return search(params, prompt)

    def search(params, prompt):
        token_logits = _make_token_logits(cfg, params)
        logits, caches = _run_prefill(cfg, params, prompt)
        vocab = logits.shape[-1]

        # seed the beams from the prompt's next-token distribution: the
        # top-W first tokens per row; every beam shares the prompt cache
        logp0 = jax.nn.log_softmax(logits, axis=-1)        # [B, V]
        scores, tok0 = jax.lax.top_k(logp0, w)             # [B, W]
        caches = [(jnp.repeat(ck, w, axis=0), jnp.repeat(cv, w, axis=0))
                  for ck, cv in caches]                    # [B*W, ...]
        hist0 = jnp.zeros((b, w, n_new), jnp.int32)
        hist0 = hist0.at[:, :, 0].set(tok0)
        done0 = (tok0 == jnp.int32(eos_id) if eos_id is not None
                 else jnp.zeros((b, w), bool))

        def step(carry, i):
            # feed each beam's token at position t0+i, extend by the
            # joint top-W over (parent beam, next token), reorder the
            # histories and caches by parent
            caches, scores, hist, last, done = carry
            logits, caches = token_logits(last.reshape(b * w), t0 + i,
                                          caches)
            logp = jax.nn.log_softmax(logits, axis=-1).reshape(b, w, vocab)
            if eos_id is not None:
                # a finished beam admits ONLY eos, at log-prob 0: its
                # score is frozen and it keeps its rank while open beams
                # keep accumulating
                eos_row = jnp.full((vocab,), _NEG_INF).at[eos_id].set(0.0)
                logp = jnp.where(done[:, :, None], eos_row, logp)
            total = scores[:, :, None] + logp              # [B, W, V]
            scores, idx = jax.lax.top_k(total.reshape(b, w * vocab), w)
            parent = idx // vocab                          # [B, W]
            tok = (idx % vocab).astype(jnp.int32)
            hist = jnp.take_along_axis(hist, parent[:, :, None], axis=1)
            hist = hist.at[:, :, i + 1].set(tok)
            flat_parent = (parent
                           + jnp.arange(b)[:, None] * w).reshape(-1)
            caches = [(ck[flat_parent], cv[flat_parent])
                      for ck, cv in caches]
            if eos_id is not None:
                done = jnp.take_along_axis(done, parent, axis=1)
                done = done | (tok == jnp.int32(eos_id))
            return (caches, scores, hist, tok, done), ()

        hist, scores_out = hist0, scores
        if n_new > 1:
            (caches, scores_out, hist, _, _), _ = jax.lax.scan(
                step, (caches, scores, hist0, tok0, done0),
                jnp.arange(n_new - 1))
        best = jnp.argmax(scores_out, axis=-1)             # [B]
        return jnp.take_along_axis(
            hist, best[:, None, None], axis=1)[:, 0]

    return jax.jit(run)


def generate_beam(net, prompt_ids, n_new, beam_width=4, eos_id=None,
                  dtype=None):
    """Fixed-length beam-search decode: returns int32 [B, T0 + n_new] —
    for each prompt row, the continuation with the highest total
    log-probability among ``beam_width`` beams.

    Both LM families (classic and llama) are supported, with the same
    batched prefill and KV caches as generate(); the beams share one
    cache tensor tiled to [B*W, ...] and REORDERED by parent beam at
    every step (a gather on the batch axis — the standard cache-reorder
    scheme). The whole search (prefill + n_new steps) is one jitted scan,
    one device dispatch, and the compiled program is cached per static
    config like generate().

    ``eos_id``: a beam that emits this token is FINISHED — its score
    freezes (later steps admit only an eos continuation at log-prob 0)
    and its tail fills with eos; unfinished beams keep competing. Without
    it, sequences are scored at the full fixed length.

    ``dtype``: serving precision, exactly as in generate() (bf16 is
    especially effective here — the cache is tiled W-fold).
    """
    prompt_ids = jnp.asarray(prompt_ids, jnp.int32)
    b, t0 = prompt_ids.shape
    w = int(beam_width)
    if w < 1:
        raise ValueError("beam_width must be >= 1, got %d" % w)
    n_vocab = None
    for lyr in net.layers:
        if isinstance(lyr, Dense):
            n_vocab = lyr.shapes["w"][1]
    if n_vocab is not None and w > n_vocab:
        raise ValueError("beam_width %d exceeds the vocab size %d"
                         % (w, n_vocab))
    cfg, params = _extract_any(net, b, t0, n_new, dtype)
    fn = _beam_fn(cfg, w, None if eos_id is None else int(eos_id))
    toks = fn(params, prompt_ids)
    return jnp.concatenate([prompt_ids, toks], axis=1)
