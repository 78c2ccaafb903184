"""Tiny transformer sequence classifier — a model family with
no reference counterpart, built ENTIRELY on the tape primitives: the
attention matmuls are batched ``dot_`` calls, the score normalization is
the fused ``softmax_`` primitive, the norms are ``layer_norm_`` — so the
whole backward pass (through softmax, batched matmuls, embeddings'
scatter-add) is generated by the same hand-VJP tape as every other model.
"""

from tinynn_autograd_tpu.nn.layers import (
    Dense, Embedding, GlobalAvgPool1D, LlamaBlock, PositionalEmbedding,
    Remat, RMSNorm, TransformerBlock,
)
from tinynn_autograd_tpu.nn.net import Net


def build_tiny_transformer(vocab=32, seq_len=16, dim=64, heads=4, depth=2,
                           num_out=10, causal=False, mlp_ratio=4,
                           dropout=0.0, attn_dropout=0.0, attn_window=None,
                           compute_dtype=None):
    """int token ids [B, T] -> class logits [B, num_out].
    ``compute_dtype`` (e.g. jnp.bfloat16) puts the blocks and the head in
    mixed precision (f32 master params; see nn.layers._to_dtype)."""
    layers = [Embedding(vocab, dim), PositionalEmbedding(seq_len, dim)]
    for _ in range(depth):
        layers.append(TransformerBlock(dim, heads, mlp_ratio=mlp_ratio,
                                       causal=causal, dropout=dropout,
                                       attn_dropout=attn_dropout,
                                       attn_window=attn_window,
                                       compute_dtype=compute_dtype))
    layers += [GlobalAvgPool1D(),
               Dense(num_out, num_in=dim, compute_dtype=compute_dtype)]
    return Net(layers)


def build_tiny_lm(vocab=32, seq_len=16, dim=64, heads=4, depth=2,
                  mlp_ratio=4, remat=False):
    """Causal language model: int token ids [B, T] -> next-token logits
    [B, T, vocab] (position t predicts token t+1; the causal mask keeps
    each position blind to its future). ``remat=True`` checkpoints each
    block (nn.layers.Remat): activation memory O(1) in depth."""
    layers = [Embedding(vocab, dim), PositionalEmbedding(seq_len, dim)]
    for _ in range(depth):
        block = TransformerBlock(dim, heads, mlp_ratio=mlp_ratio,
                                 causal=True)
        layers.append(Remat(block) if remat else block)
    layers.append(Dense(vocab, num_in=dim))
    return Net(layers)


def build_tiny_vit(image_shape=(28, 28, 1), patch=4, dim=64, heads=4,
                   depth=2, num_out=10, mlp_ratio=4, dropout=0.0):
    """Vision transformer classifier by PURE COMPOSITION of existing
    layers: Conv2D patchify (kernel == stride == patch, one token per
    non-overlapping patch — the standard ViT embedding, the same conv
    path as the CNN family), Reshape to the [B, T, D]
    token sequence, learned position embeddings, TransformerBlocks,
    mean-pool, linear head. Input: images [B, H, W, C]."""
    h, w, c = image_shape
    if h % patch or w % patch:
        raise ValueError("image %dx%d not divisible by patch %d"
                         % (h, w, patch))
    t = (h // patch) * (w // patch)
    from tinynn_autograd_tpu.nn.layers import Conv2D, Reshape

    layers = [
        Conv2D((patch, patch, c, dim), stride=patch, padding="VALID"),
        Reshape((t, dim)),
        PositionalEmbedding(t, dim),
    ]
    for _ in range(depth):
        layers.append(TransformerBlock(dim, heads, mlp_ratio=mlp_ratio,
                                       dropout=dropout))
    layers += [GlobalAvgPool1D(), Dense(num_out, num_in=dim)]
    return Net(layers)


def build_tiny_llama(vocab=32, dim=64, heads=4, kv_heads=None, depth=2,
                     mlp_ratio=8 / 3, rope_base=10000.0, remat=False,
                     dropout=0.0, attn_dropout=0.0, attn_window=None,
                     compute_dtype=None):
    """Modern decoder LM (llama-family): int token ids [B, T] ->
    next-token logits [B, T, vocab]. Pre-RMSNorm LlamaBlocks with RoPE
    (no PositionalEmbedding — positions live in the rotary phases, so T
    is bounded only by memory, not a learned table), grouped-query
    attention when ``kv_heads`` < ``heads``, SwiGLU MLPs, a final RMSNorm
    before the head. ``remat=True`` checkpoints each block. Serving:
    models.generate() decodes this family with a KV cache held at
    ``kv_heads`` heads (the GQA cache saving)."""
    layers = [Embedding(vocab, dim)]
    for _ in range(depth):
        block = LlamaBlock(dim, heads, num_kv_heads=kv_heads,
                           mlp_ratio=mlp_ratio, causal=True,
                           rope_base=rope_base, dropout=dropout,
                           attn_dropout=attn_dropout,
                           attn_window=attn_window,
                           compute_dtype=compute_dtype)
        layers.append(Remat(block) if remat else block)
    layers += [RMSNorm(dim),
               Dense(vocab, num_in=dim, compute_dtype=compute_dtype)]
    return Net(layers)
