"""Network layers and activations (reference surface: core/layers.py).

Every layer's forward is pure Tensor-algebra over the autograd primitives, so
the same code path runs eagerly on device AND traces into the single fused
XLA train-step program (see nn/model.py). Layers own their parameters as
Tensors (lazy-initialized from the first input's shape, preserving the
reference's API, reference: core/layers.py:43-46) and expose
``param_shapes`` for checkpoint compatibility checks.

Reference bugs fixed here (see SURVEY.md §2):
- Sigmoid: the reference calls np.exp on a Tensor and crashes
  (reference core/layers.py:74-80); ours is the real stable logistic.
- Tanh: the reference computes tanh(x/2) (reference core/layers.py:83-89);
  ours is true tanh.

Additions beyond the reference: Conv2D + MaxPool2D (the reference has pad_
and conv-aware get_fans but no conv layer), Flatten, Dropout, LeakyReLU /
GELU / Softplus, and the sequence, attention and MoE layers below.
"""

import contextlib

import numpy as np

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.nn.initializer import (
    NormalInit, OnesInit, XavierUniformInit, ZerosInit,
)
from tinynn_autograd_tpu.utils import seeder


def _init_scope(seed):
    """Parameter-draw scope: a dedicated PRNG stream when the layer was
    given an explicit ``seed``, else the global seeder stream. Explicit
    seeds make a layer's init independent of GLOBAL draw order (the
    lazy-init footgun: two models built before either trains otherwise
    interleave their draws on the global stream)."""
    return (seeder.scope(seed) if seed is not None
            else contextlib.nullcontext())


def _norm_f32(t):
    """Norm cores run in f32 (the mixed-precision policy): upcast a
    sub-32-bit input before the fused norm primitive — otherwise the
    mean/variance reductions of a bf16 residual stream would run at bf16
    resolution. f32/f64 inputs pass through untouched; the astype_ VJP
    returns the cotangent in the stream's dtype."""
    import jax.numpy as jnp

    d = t.dtype
    if jnp.issubdtype(d, jnp.inexact) and jnp.finfo(d).bits < 32:
        return ops.astype_(t, np.float32)
    return t


def _to_dtype(t, dtype):
    """Tape-tracked cast, a no-op when the dtype already matches.

    This is the whole mixed-precision mechanism: ``astype_``'s VJP casts
    the cotangent back to the SOURCE dtype, so casting an f32 master
    parameter to bf16 at its use site yields an f32 gradient for the f32
    master weight — the standard mixed-precision discipline (params and
    optimizer state stay f32; matmul operands and the activations that
    flow between layers are bf16). bf16 shares f32's exponent range, so
    no loss scaling is needed (that is an fp16 artifact)."""
    if dtype is None:
        return t
    from tinynn_autograd_tpu.core.tensor import as_tensor

    t = as_tensor(t)
    if t.dtype == np.dtype(dtype):
        return t
    return ops.astype_(t, dtype)


class Layer:
    """Base layer: named, owns ``params``/``grads`` dicts and a training
    flag (reference contract: core/layers.py:10-22)."""

    def __init__(self, name):
        self.name = name
        self.params, self.grads = {}, {}
        self.is_training = True

    def forward(self, inputs):
        raise NotImplementedError

    def init_params(self, input_shape):
        """Static shape inference: materialize lazy params (if any) and
        return the output shape. Default: shape-preserving, no params."""
        return input_shape

    def set_phase(self, phase):
        self.is_training = phase == "TRAIN"

    @property
    def param_shapes(self):
        return {k: tuple(v.shape) for k, v in self.params.items() if v is not None}

    # layers with parameters override; others are always "initialized"
    @property
    def is_init(self):
        return True


class Dense(Layer):
    """y = x @ w + b; w: [num_in, num_out], b: [1, num_out]
    (reference: core/layers.py:25-57). ``num_in`` may be omitted and is
    inferred from the first input (lazy init). ``seed`` pins the layer's
    parameter draws to a dedicated PRNG stream independent of global draw
    order (see utils.seeder.scope).

    ``compute_dtype`` (e.g. ``jnp.bfloat16``) enables mixed precision:
    the input and both parameters are cast at the use site, so the matmul
    runs and the OUTPUT flows downstream in that dtype (halved activation
    HBM traffic), while the stored parameters, their gradients, and the
    optimizer state all stay f32 master copies (see _to_dtype)."""

    def __init__(self, num_out, num_in=None,
                 w_init=None, b_init=None, seed=None, compute_dtype=None):
        super().__init__("Linear")
        self.compute_dtype = compute_dtype
        self.initializers = {
            "w": w_init if w_init is not None else XavierUniformInit(),
            "b": b_init if b_init is not None else ZerosInit(),
        }
        self.shapes = {"w": [num_in, num_out], "b": [1, num_out]}
        self.params = {"w": None, "b": None}
        self._seed = seed

        self._is_init = False
        if num_in is not None:
            self._init_parameters(num_in)

    @property
    def is_init(self):
        return self._is_init

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        cd = self.compute_dtype
        if cd is None:
            return inputs @ self.params["w"] + self.params["b"]
        # bf16 operands feed the tensor cores; the matmul ACCUMULATES in
        # f32 (kernels.matmul invariant), and the result rounds ONCE at
        # the layer boundary so the downstream activation flows in cd
        return _to_dtype(
            _to_dtype(inputs, cd) @ _to_dtype(self.params["w"], cd)
            + _to_dtype(self.params["b"], cd), cd)

    def init_params(self, input_shape):
        """Shape-only initialization (no compute) so jitted paths can
        materialize params before tracing."""
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return (input_shape[0], self.shapes["w"][1])

    def _init_parameters(self, input_size):
        self.shapes["w"][0] = int(input_size)
        with _init_scope(self._seed):
            self.params["w"] = self.initializers["w"](self.shapes["w"])
            self.params["b"] = self.initializers["b"](self.shapes["b"])
        self._is_init = True


class LayerNorm(Layer):
    """Layer normalization over the last axis with learned gamma/beta
    (ops.layer_norm_ fused primitive, hand VJPs). Stateless — works in
    every execution path (eager, fused step, scanned epochs).
    ``dim`` may be omitted and is inferred from the first input (lazy
    init, like Dense). No reference counterpart (the reference has no
    normalization layers)."""

    def __init__(self, dim=None, eps=1e-5, gamma_init=None, beta_init=None):
        super().__init__("LayerNorm")
        self.eps = eps
        self.initializers = {
            "gamma": gamma_init if gamma_init is not None else OnesInit(),
            "beta": beta_init if beta_init is not None else ZerosInit(),
        }
        self.shapes = {"gamma": [1, dim], "beta": [1, dim]}
        self.params = {"gamma": None, "beta": None}
        self._is_init = False
        if dim is not None:
            self._init_parameters(dim)

    @property
    def is_init(self):
        return self._is_init

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return ops.layer_norm_(_norm_f32(inputs), self.params["gamma"],
                               self.params["beta"], eps=self.eps)

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return tuple(input_shape)

    def _init_parameters(self, dim):
        self.shapes = {"gamma": [1, int(dim)], "beta": [1, int(dim)]}
        self.params["gamma"] = self.initializers["gamma"](self.shapes["gamma"])
        self.params["beta"] = self.initializers["beta"](self.shapes["beta"])
        self._is_init = True


class RMSNorm(Layer):
    """RMS normalization over the last axis with a learned scale only —
    no centering, no shift (ops.rms_norm_ fused primitive, hand VJP).
    The llama-family norm: cheaper than LayerNorm (no mean pass) and the
    standard choice for modern decoder LMs. ``dim`` may be omitted and is
    inferred from the first input. Stateless — runs in every execution
    tier. No reference counterpart."""

    def __init__(self, dim=None, eps=1e-6, gamma_init=None):
        super().__init__("RMSNorm")
        self.eps = eps
        self.initializers = {
            "g": gamma_init if gamma_init is not None else OnesInit(),
        }
        self.shapes = {"g": [1, dim]}
        self.params = {"g": None}
        self._is_init = False
        if dim is not None:
            self._init_parameters(dim)

    @property
    def is_init(self):
        return self._is_init

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return ops.rms_norm_(_norm_f32(inputs), self.params["g"],
                             eps=self.eps)

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return tuple(input_shape)

    def _init_parameters(self, dim):
        self.shapes = {"g": [1, int(dim)]}
        self.params["g"] = self.initializers["g"](self.shapes["g"])
        self._is_init = True


class Embedding(Layer):
    """Token embedding: int ids [..] -> vectors [.., dim] via table lookup.
    The lookup is ``ops.getitem_`` whose VJP scatter-ADDS (repeated tokens
    accumulate gradient — the correct adjoint; reference getitem overwrote,
    reference: core/ops.py:285-288). No reference counterpart layer."""

    def __init__(self, vocab, dim, w_init=None, seed=None):
        super().__init__("Embedding")
        self.initializers = {
            "w": w_init if w_init is not None else NormalInit(std=0.02),
        }
        self.shapes = {"w": [vocab, dim]}
        self.params = {"w": None}
        self._seed = seed
        self._init_parameters()

    def _init_parameters(self):
        with _init_scope(self._seed):
            self.params["w"] = self.initializers["w"](self.shapes["w"])

    def init_params(self, input_shape):
        return tuple(input_shape) + (self.shapes["w"][1],)

    def forward(self, inputs):
        ids = inputs.data if hasattr(inputs, "data") else inputs
        return self.params["w"][ids]


class PositionalEmbedding(Layer):
    """Learned additive position embedding: x [B, T, D] + pos [1, T, D]."""

    def __init__(self, seq_len, dim, w_init=None, seed=None):
        super().__init__("PositionalEmbedding")
        self.initializers = {
            "pos": w_init if w_init is not None else NormalInit(std=0.02),
        }
        self.shapes = {"pos": [1, seq_len, dim]}
        with _init_scope(seed):
            self.params = {
                "pos": self.initializers["pos"](self.shapes["pos"])}

    def init_params(self, input_shape):
        return tuple(input_shape)

    def forward(self, inputs):
        return inputs + self.params["pos"]


class TransformerBlock(Layer):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + MLP(LN(x)).

    Everything is ordinary Tensor algebra over the tape primitives —
    batched N-D ``dot_`` for the attention matmuls, the fused ``softmax_``
    primitive on the score rows, ``layer_norm_`` for the two norms — so
    the SAME code runs eagerly and inside the fused jitted step, and the
    whole backward (including through softmax and the batched matmuls) is
    generated by the tape's hand-written VJPs. ``causal=True`` adds the
    standard -inf upper-triangular mask before the softmax. No reference
    counterpart (the reference has no attention or sequence models).

    ``attn``: "fused" (default) runs the attention core as the ONE
    flash-style primitive ``ops.flash_attention_`` — Triton online-
    softmax kernels on the GPU for long sequences (no [T, T] score tensors
    in device memory; exact-math XLA twin elsewhere, see
    ops/attention.py); "tape" keeps the explicit
    4-primitive chain (same numerics — the cross-check path, and the one
    the parallel wrappers mirror for their sharded attention).

    ``dropout``: inverted dropout on the attention-projection and MLP
    outputs (the standard residual-dropout sites); ``attn_dropout``:
    dropout on the attention probabilities. Under ``attn="fused"`` the
    probability masks are generated and REPLAYED inside the flash kernels
    from a counter-hash of the absolute (head, query, key) index — no
    [T, T] mask tensor ever exists (see ops/attention.py "dropout
    machinery"); under ``attn="tape"`` they're ordinary ops.dropout_
    masks on the materialized probabilities (different mask stream, same
    distribution). Masks are drawn from the rng the Model threads per
    step (fresh under jit), or the global seeder eagerly; identity in
    TEST phase.
    """

    def __init__(self, dim, num_heads, mlp_ratio=4, causal=False,
                 w_init=None, eps=1e-5, seed=None, attn="fused",
                 dropout=0.0, attn_dropout=0.0, attn_window=None,
                 compute_dtype=None):
        super().__init__("TransformerBlock")
        assert dim % num_heads == 0, (dim, num_heads)
        assert attn in ("fused", "tape"), attn
        if attn_window is not None and not causal:
            raise ValueError("attn_window (sliding-window attention) "
                             "requires causal=True")
        self.attn_window = attn_window
        # mixed precision: the residual stream, every matmul, and the MLP
        # run in compute_dtype; the two layer norms and the attention core
        # (softmax) run in f32 (the standard policy — see _to_dtype);
        # params/grads/optimizer state stay f32 masters
        self.compute_dtype = compute_dtype
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.causal = causal
        self.attn = attn
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.eps = eps
        self._rng = None
        if dropout or attn_dropout:
            # only dropout-carrying blocks advertise set_rng: the Model
            # threads per-step keys to layers that HAVE it, and wrappers
            # that can't support stochastic layers reject on it
            self.set_rng = self._set_rng
        init = w_init if w_init is not None else XavierUniformInit()
        hidden = int(dim * mlp_ratio)
        self.shapes = {
            "wq": [dim, dim], "wk": [dim, dim], "wv": [dim, dim],
            "wo": [dim, dim],
            "w1": [dim, hidden], "b1": [1, hidden],
            "w2": [hidden, dim], "b2": [1, dim],
            "g1": [1, dim], "be1": [1, dim],
            "g2": [1, dim], "be2": [1, dim],
        }
        zeros = ZerosInit()
        ones = OnesInit()
        self.params = {}
        with _init_scope(seed):
            for k, shape in self.shapes.items():
                if k.startswith("g"):
                    self.params[k] = ones(shape)
                elif k.startswith(("b", "be")):
                    self.params[k] = zeros(shape)
                else:
                    self.params[k] = init(shape)

    def init_params(self, input_shape):
        return tuple(input_shape)

    def _set_rng(self, rng):
        self._rng = rng

    def _drop_keys(self):
        """Three decorrelated mask sources (attn probs, attn-proj out, MLP
        out) from the threaded per-step rng (or the global seeder)."""
        rng = self._rng
        self._rng = None
        if rng is None:
            rng = seeder.next_key()
        import jax

        return list(jax.random.split(rng, 3))

    def _mask(self, t):
        import jax.numpy as jnp

        from tinynn_autograd_tpu.ops.attention import band_mask

        if not self.causal:
            return None
        return jnp.where(band_mask(t, self.attn_window), 0.0, -1e9)

    def forward(self, inputs):
        p = self.params
        b, t, d = inputs.shape
        h, hd = self.num_heads, self.head_dim
        cd = self.compute_dtype
        if cd is not None:
            cast = lambda x: _to_dtype(x, cd)          # noqa: E731
            up = lambda x: _to_dtype(x, np.float32)    # noqa: E731
        else:
            cast = up = lambda x: x                    # noqa: E731

        def split_heads(x):  # [B,T,D] -> [B,H,T,hd]
            return x.reshape((b, t, h, hd)).transpose((0, 2, 1, 3))

        drop = (self.is_training
                and (self.dropout > 0.0 or self.attn_dropout > 0.0))
        keys = self._drop_keys() if drop else None

        inputs = cast(inputs)
        xn = cast(ops.layer_norm_(up(inputs), p["g1"], p["be1"],
                                  eps=self.eps))
        q = up(split_heads(xn @ cast(p["wq"])))
        k = up(split_heads(xn @ cast(p["wk"])))
        v = up(split_heads(xn @ cast(p["wv"])))
        if self.attn == "fused":
            attn_rate = (self.attn_dropout
                         if drop and self.attn_dropout > 0.0 else 0.0)
            ctx_h = ops.flash_attention_(
                q, k, v, causal=self.causal, scale=1.0 / np.sqrt(hd),
                dropout_rate=attn_rate,
                dropout_rng=keys[0] if attn_rate else None,
                window=self.attn_window)
        else:
            scores = (q @ k.transpose((0, 1, 3, 2))) * (1.0 / np.sqrt(hd))
            mask = self._mask(t)
            if mask is not None:
                scores = scores + mask
            attn = ops.softmax_(scores, axis=-1)
            if drop and self.attn_dropout > 0.0:
                attn = ops.dropout_(attn, self.attn_dropout, keys[0])
            ctx_h = attn @ v
        ctx = cast(ctx_h.transpose((0, 2, 1, 3)).reshape((b, t, d)))
        # every matmul accumulates f32 (kernels.matmul invariant); cast()
        # rounds the result once so the residual stream stays in cd
        attn_out = cast(ctx @ cast(p["wo"]))
        if drop and self.dropout > 0.0:
            attn_out = ops.dropout_(attn_out, self.dropout, keys[1])
        x = inputs + attn_out

        yn = cast(ops.layer_norm_(up(x), p["g2"], p["be2"], eps=self.eps))
        y = cast(ops.gelu_(yn @ cast(p["w1"]) + cast(p["b1"]))
                 @ cast(p["w2"]) + cast(p["b2"]))
        if drop and self.dropout > 0.0:
            y = ops.dropout_(y, self.dropout, keys[2])
        return x + y


def _repeat_heads(x, group):
    """[B, Hkv, T, hd] -> [B, Hkv*group, T, hd]: repeat each kv head
    ``group`` times (GQA's kv -> query-head broadcast). Tape-level: a
    reshape, a broadcasting multiply by ones — whose mul_ unbroadcast SUMS
    the cotangents over the group axis, which is exactly GQA's dk/dv
    reduction — and a reshape back. XLA fuses the broadcast into the
    consumer, so no repeated copy materializes in the forward."""
    b, hkv, t, hd = x.shape
    x5 = x.reshape((b, hkv, 1, t, hd))
    rep = x5 * np.ones((1, 1, group, 1, 1), np.float32)
    return rep.reshape((b, hkv * group, t, hd))


class LlamaBlock(Layer):
    """Modern decoder block (llama-family): pre-RMSNorm, rotary position
    embeddings (RoPE) on q/k, grouped-query attention, SwiGLU MLP, and no
    biases anywhere — the standard contemporary LM block, built on the
    SAME tape primitives and flash-attention kernels as TransformerBlock.

    ``num_kv_heads`` < ``num_heads`` enables GQA (``num_kv_heads=1`` is
    MQA): K/V are projected at Hkv heads — the parameter AND KV-cache
    saving — and broadcast to the query heads before the attention
    primitive (see _repeat_heads; the serving path in models/generate.py
    keeps the cache at Hkv heads end-to-end). ``mlp_ratio`` sizes the
    SwiGLU hidden dim as round(dim * ratio / 8) * 8 (lane-aligned); the
    default 8/3 matches llama's parameter budget vs a ratio-4 GELU MLP.

    Positions come from RoPE, so llama nets need no PositionalEmbedding
    layer and the block is translation-aware by construction. ``attn``
    and the two dropout knobs behave exactly as in TransformerBlock
    (in-kernel replayed masks under ``attn="fused"``). No reference
    counterpart (the reference has no attention or sequence models).
    """

    _set_rng = TransformerBlock._set_rng
    _drop_keys = TransformerBlock._drop_keys
    _mask = TransformerBlock._mask

    def __init__(self, dim, num_heads, num_kv_heads=None, mlp_ratio=8 / 3,
                 causal=True, w_init=None, eps=1e-6, rope_base=10000.0,
                 seed=None, attn="fused", dropout=0.0, attn_dropout=0.0,
                 attn_window=None, compute_dtype=None):
        super().__init__("LlamaBlock")
        assert dim % num_heads == 0, (dim, num_heads)
        assert attn in ("fused", "tape"), attn
        if attn_window is not None and not causal:
            raise ValueError("attn_window (sliding-window attention) "
                             "requires causal=True")
        self.attn_window = attn_window
        # mixed precision: same policy as TransformerBlock (residual
        # stream + matmuls + SwiGLU in compute_dtype; RMSNorm, RoPE, and
        # the attention core in f32; f32 master params)
        self.compute_dtype = compute_dtype
        num_kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        assert num_heads % num_kv_heads == 0, (num_heads, num_kv_heads)
        self.dim = dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = dim // num_heads
        self.causal = causal
        self.attn = attn
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.eps = eps
        self.rope_base = float(rope_base)
        self._rng = None
        if dropout or attn_dropout:
            self.set_rng = self._set_rng
        init = w_init if w_init is not None else XavierUniformInit()
        hidden = max(8, int(round(dim * mlp_ratio / 8)) * 8)
        self.hidden = hidden
        kv_dim = num_kv_heads * self.head_dim
        self.shapes = {
            "wq": [dim, dim], "wk": [dim, kv_dim], "wv": [dim, kv_dim],
            "wo": [dim, dim],
            "w1": [dim, hidden], "w3": [dim, hidden], "w2": [hidden, dim],
            "g1": [1, dim], "g2": [1, dim],
        }
        ones = OnesInit()
        self.params = {}
        with _init_scope(seed):
            for key, shape in self.shapes.items():
                self.params[key] = (ones(shape) if key.startswith("g")
                                    else init(shape))

    def init_params(self, input_shape):
        return tuple(input_shape)

    def forward(self, inputs):
        p = self.params
        b, t, d = inputs.shape
        h, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        cd = self.compute_dtype
        if cd is not None:
            cast = lambda x: _to_dtype(x, cd)          # noqa: E731
            up = lambda x: _to_dtype(x, np.float32)    # noqa: E731
        else:
            cast = up = lambda x: x                    # noqa: E731

        drop = (self.is_training
                and (self.dropout > 0.0 or self.attn_dropout > 0.0))
        keys = self._drop_keys() if drop else None

        inputs = cast(inputs)
        xn = cast(ops.rms_norm_(up(inputs), p["g1"], eps=self.eps))
        q = up((xn @ cast(p["wq"]))
               .reshape((b, t, h, hd)).transpose((0, 2, 1, 3)))
        k = up((xn @ cast(p["wk"]))
               .reshape((b, t, hkv, hd)).transpose((0, 2, 1, 3)))
        v = up((xn @ cast(p["wv"]))
               .reshape((b, t, hkv, hd)).transpose((0, 2, 1, 3)))
        q = ops.rope_(q, base=self.rope_base)
        k = ops.rope_(k, base=self.rope_base)
        if self.attn == "fused":
            # GQA is native in the flash primitive: one kernel call per
            # query group against the SHARED K/V — the repeated
            # [B, H, T, hd] K/V never materializes in HBM
            attn_rate = (self.attn_dropout
                         if drop and self.attn_dropout > 0.0 else 0.0)
            ctx_h = ops.flash_attention_(
                q, k, v, causal=self.causal, scale=1.0 / np.sqrt(hd),
                dropout_rate=attn_rate,
                dropout_rng=keys[0] if attn_rate else None,
                window=self.attn_window)
        else:
            if hkv != h:
                k = _repeat_heads(k, h // hkv)
                v = _repeat_heads(v, h // hkv)
            scores = (q @ k.transpose((0, 1, 3, 2))) * (1.0 / np.sqrt(hd))
            mask = self._mask(t)
            if mask is not None:
                scores = scores + mask
            attn = ops.softmax_(scores, axis=-1)
            if drop and self.attn_dropout > 0.0:
                attn = ops.dropout_(attn, self.attn_dropout, keys[0])
            ctx_h = attn @ v
        ctx = cast(ctx_h.transpose((0, 2, 1, 3)).reshape((b, t, d)))
        # matmuls accumulate f32 (kernels.matmul invariant); cast() rounds
        # the result once so the residual stream stays in cd
        attn_out = cast(ctx @ cast(p["wo"]))
        if drop and self.dropout > 0.0:
            attn_out = ops.dropout_(attn_out, self.dropout, keys[1])
        x = inputs + attn_out

        yn = cast(ops.rms_norm_(up(x), p["g2"], eps=self.eps))
        y = cast((ops.silu_(yn @ cast(p["w1"])) * (yn @ cast(p["w3"])))
                 @ cast(p["w2"]))
        if drop and self.dropout > 0.0:
            y = ops.dropout_(y, self.dropout, keys[2])
        return x + y


class MoE(Layer):
    """Switch-style top-1 mixture-of-experts MLP over the last axis:
    each token is routed to ONE expert (argmax of a softmax gate) and the
    output is scaled by the chosen gate probability, so the router trains
    through the probability (the standard straight-through-free Switch
    gradient; the discrete CHOICE itself is not differentiated).

    Compute is the exact dense-select formulation — EVERY expert runs on
    EVERY token and a one-hot mask selects, i.e. the layer costs E x the
    routed FLOPs. That keeps the numerics bit-deterministic and lets
    parallel.ExpertParallel shard the EXPERTS across a mesh with one psum,
    remaining exactly equal to single-device — but it is NOT the scaling
    path: for production-scale expert counts use
    ``ExpertParallel(..., dispatch="a2a")`` (capacity-factor all_to_all
    token dispatch, aggregate FLOPs ~ capacity_factor/E of dense-select).
    Params are stacked [E, ...] leaves (batched matmuls).
    No reference counterpart."""

    def __init__(self, num_experts, dim=None, hidden=None, w_init=None,
                 gate_init=None, seed=None):
        super().__init__("MoE")
        self.num_experts = num_experts
        self.dim = dim
        self.hidden = hidden
        self._seed = seed
        self._w_init = w_init if w_init is not None else XavierUniformInit()
        self._g_init = (gate_init if gate_init is not None
                        else NormalInit(std=0.02))
        self.params = {"wg": None, "w1": None, "b1": None,
                       "w2": None, "b2": None}
        self.shapes = {}
        self._is_init = False
        if dim is not None:
            self._init_parameters(dim)

    @property
    def is_init(self):
        return self._is_init

    def _init_parameters(self, dim):
        from tinynn_autograd_tpu.core.tensor import Tensor

        dim = int(dim)
        self.dim = dim
        hidden = self.hidden if self.hidden is not None else 4 * dim
        self.hidden = hidden
        E = self.num_experts
        self.shapes = {"wg": [dim, E], "w1": [E, dim, hidden],
                       "b1": [E, 1, hidden], "w2": [E, hidden, dim],
                       "b2": [E, 1, dim]}
        with _init_scope(self._seed):
            self.params["wg"] = self._g_init(self.shapes["wg"])
            # per-expert fan-correct draws, stacked
            w1 = [self._w_init((dim, hidden)).data for _ in range(E)]
            w2 = [self._w_init((hidden, dim)).data for _ in range(E)]
        import jax.numpy as jnp

        self.params["w1"] = Tensor(jnp.stack(w1), requires_grad=True)
        self.params["w2"] = Tensor(jnp.stack(w2), requires_grad=True)
        self.params["b1"] = Tensor(jnp.zeros((E, 1, hidden)),
                                   requires_grad=True)
        self.params["b2"] = Tensor(jnp.zeros((E, 1, dim)),
                                   requires_grad=True)
        self._is_init = True

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return tuple(input_shape)

    def route(self, inputs):
        """Returns (flat tokens Tensor [N, D], probs Tensor [N, E],
        one-hot mask array [N, E]); the argmax choice is data-dependent
        but shape-static."""
        import jax.numpy as jnp

        flat = inputs.reshape((-1, self.dim))
        probs = ops.softmax_(flat @ self.params["wg"], axis=-1)
        choice = jnp.argmax(probs.data, axis=-1)
        onehot = jnp.eye(self.num_experts, dtype=jnp.float32)[choice]
        return flat, probs, onehot

    def expert_outputs(self, flat, w1, b1, w2, b2):
        """All experts on all tokens: [E, N, D] (batched matmuls)."""
        h = ops.relu_(flat.reshape((1,) + tuple(flat.shape)) @ w1 + b1)
        return h @ w2 + b2

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        shape = inputs.shape
        flat, probs, onehot = self.route(inputs)
        out_e = self.expert_outputs(flat, self.params["w1"],
                                    self.params["b1"], self.params["w2"],
                                    self.params["b2"])
        # select each token's expert and scale by its gate probability
        sel = ops.sum_(out_e * onehot.T[:, :, None], axis=0)
        g = ops.sum_(probs * onehot, axis=-1, keepdims=True)
        return (sel * g).reshape(shape)


class GlobalAvgPool1D(Layer):
    """[B, T, D] -> [B, D]: mean over the sequence axis (readout head for
    sequence classifiers)."""

    def __init__(self):
        super().__init__("GlobalAvgPool1D")

    def init_params(self, input_shape):
        return (input_shape[0], input_shape[2])

    def forward(self, inputs):
        return ops.mean_(inputs, axis=1)


class _RecurrentBase(Layer):
    """Shared plumbing for the recurrent layers (LSTM/GRU): fused-gate
    weight layout wx [D, G*H] / wh [H, G*H] / b [1, G*H], lazy init from
    the first input's feature size, and the full-sequence-vs-last-step
    output policy. The reference has no recurrent machinery at all (its
    only model family is the MLP, reference examples/mnist/run.py:59-69);
    these layers are additions built on the single-scan BPTT
    primitives in ops/recurrent.py."""

    _GATES = None  # subclass: number of fused gates G

    def __init__(self, name, num_hidden, num_in=None, return_sequences=False,
                 w_init=None, u_init=None, seed=None, reverse=False):
        super().__init__(name)
        self.num_hidden = int(num_hidden)
        self.return_sequences = return_sequences
        self.reverse = reverse
        self._seed = seed
        self.initializers = {
            "wx": w_init if w_init is not None else XavierUniformInit(),
            "wh": u_init if u_init is not None else XavierUniformInit(),
        }
        g = self._GATES
        self.shapes = {"wx": [num_in, g * self.num_hidden],
                       "wh": [self.num_hidden, g * self.num_hidden],
                       "b": [1, g * self.num_hidden]}
        self.params = {"wx": None, "wh": None, "b": None}
        self._is_init = False
        if num_in is not None:
            self._init_parameters(num_in)

    @property
    def is_init(self):
        return self._is_init

    def _bias_data(self):
        import jax.numpy as jnp

        return jnp.zeros(tuple(self.shapes["b"]), dtype=jnp.float32)

    def _init_parameters(self, input_size):
        from tinynn_autograd_tpu.core.tensor import Tensor

        self.shapes["wx"][0] = int(input_size)
        with _init_scope(self._seed):
            self.params["wx"] = self.initializers["wx"](self.shapes["wx"])
            self.params["wh"] = self.initializers["wh"](self.shapes["wh"])
        self.params["b"] = Tensor(self._bias_data(), requires_grad=True)
        self._is_init = True

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.num_hidden)
        return (input_shape[0], self.num_hidden)

    def _scan(self, inputs):
        raise NotImplementedError

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        hs = self._scan(inputs)
        if self.return_sequences:
            return hs
        # a reverse-direction cell's final state sits at position 0
        # (outputs stay aligned to input positions; see ops/recurrent.py)
        return hs[:, 0] if self.reverse else hs[:, -1]


class LSTM(_RecurrentBase):
    """LSTM over [B, T, D] -> [B, H] (last hidden state) or [B, T, H]
    (``return_sequences=True``). One ``ops.lstm_scan_`` tape primitive:
    the whole recurrence is a single forward scan kernel plus a single
    hand-written reverse-scan BPTT kernel — compile time and kernel count
    independent of T (see ops/recurrent.py).

    The forget-gate bias initializes to 1.0 (the standard
    remember-by-default trick; gates fused in i, f, g, o order)."""

    _GATES = 4

    def __init__(self, num_hidden, num_in=None, return_sequences=False,
                 w_init=None, u_init=None, seed=None, reverse=False):
        super().__init__("LSTM", num_hidden, num_in=num_in,
                         return_sequences=return_sequences,
                         w_init=w_init, u_init=u_init, seed=seed,
                         reverse=reverse)

    def _bias_data(self):
        import jax.numpy as jnp

        h = self.num_hidden
        return (jnp.zeros((1, 4 * h), dtype=jnp.float32)
                .at[:, h:2 * h].set(1.0))

    def _scan(self, inputs):
        from tinynn_autograd_tpu.ops.recurrent import lstm_scan_

        return lstm_scan_(inputs, self.params["wx"], self.params["wh"],
                          self.params["b"], reverse=self.reverse)


class GRU(_RecurrentBase):
    """GRU over [B, T, D] -> [B, H] or [B, T, H] (``return_sequences``).
    One ``ops.gru_scan_`` primitive (single-bias Cho et al. form, gates
    fused in z, r, n order); same single-scan-each-way compilation story
    as LSTM."""

    _GATES = 3

    def __init__(self, num_hidden, num_in=None, return_sequences=False,
                 w_init=None, u_init=None, seed=None, reverse=False):
        super().__init__("GRU", num_hidden, num_in=num_in,
                         return_sequences=return_sequences,
                         w_init=w_init, u_init=u_init, seed=seed,
                         reverse=reverse)

    def _scan(self, inputs):
        from tinynn_autograd_tpu.ops.recurrent import gru_scan_

        return gru_scan_(inputs, self.params["wx"], self.params["wh"],
                         self.params["b"], reverse=self.reverse)


class _TwoWayParams:
    """Write-through merged view over the two direction layers' param
    dicts: keys are ``f_<name>`` / ``b_<name>``. Net/Model only ever use
    the mapping surface below (keys/values/items/get/set), and
    ``params_tree`` copies it into plain dicts, so checkpoints and the
    jitted tiers see ordinary pytrees."""

    def __init__(self, fwd, bwd):
        self._fwd, self._bwd = fwd, bwd

    def _route(self, key):
        side, name = key.split("_", 1)
        return (self._fwd if side == "f" else self._bwd).params, name

    def keys(self):
        # dict_keys, not a list: Net.set_parameters compares with the
        # checkpoint dict's .keys() (set semantics)
        return dict.fromkeys(
            [("f_%s" % k) for k in self._fwd.params]
            + [("b_%s" % k) for k in self._bwd.params]).keys()

    def __iter__(self):
        return iter(self.keys())

    def __getitem__(self, key):
        inner, name = self._route(key)
        return inner[name]

    def __setitem__(self, key, value):
        inner, name = self._route(key)
        inner[name] = value

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def __eq__(self, other):
        return dict(self.items()) == dict(
            other.items() if hasattr(other, "items") else other)


class Bidirectional(Layer):
    """Bidirectional wrapper over a recurrent layer (LSTM/GRU): runs the
    wrapped cell forward in time and an independent twin backward in time
    (``reverse=True`` on the scan primitive — the BPTT scan simply flips
    direction, see ops/recurrent.py), concatenating the two outputs on
    the feature axis. Output: [B, T, 2H] with ``return_sequences=True``
    on the wrapped layer, else [B, 2H] (forward cell's last state ++
    backward cell's state at position 0 — the Keras convention).

    ``backward_layer`` defaults to a fresh twin of the wrapped layer
    (same class/width/return_sequences, its own init draw). Params are
    exposed as a write-through merged dict (keys ``f_*`` / ``b_*``) so
    optimizers, checkpointing, and the jitted tiers see one ordinary
    layer. No reference counterpart (the reference has no recurrent
    machinery at all)."""

    def __init__(self, forward_layer, backward_layer=None):
        if forward_layer.reverse:
            raise ValueError("Bidirectional's wrapped layer must run "
                             "forward (reverse=False); the wrapper builds "
                             "the reverse twin itself.")
        if backward_layer is None:
            seed = forward_layer._seed
            num_in = (forward_layer.shapes["wx"][0]
                      if forward_layer.is_init else None)
            backward_layer = type(forward_layer)(
                forward_layer.num_hidden, num_in=num_in,
                return_sequences=forward_layer.return_sequences,
                seed=None if seed is None else seed + 0x9E37,
                reverse=True)
        else:
            if not backward_layer.reverse:
                raise ValueError("backward_layer must have reverse=True")
            if (backward_layer.return_sequences
                    != forward_layer.return_sequences):
                raise ValueError("forward/backward return_sequences differ")
        # fwd/bwd must exist before super().__init__: the base assigns
        # ``self.params = {}`` which routes through the property setter
        self.fwd = forward_layer
        self.bwd = backward_layer
        super().__init__("Bidirectional(%s)" % forward_layer.name)

    @property
    def params(self):
        return _TwoWayParams(self.fwd, self.bwd)

    @params.setter
    def params(self, value):
        view = _TwoWayParams(self.fwd, self.bwd)
        for k in value.keys():
            view[k] = value[k]

    @property
    def is_init(self):
        return self.fwd.is_init and self.bwd.is_init

    # Model.load marks lazily-built layers initialized by assigning
    # _is_init after installing checkpoint params — forward it to both
    # direction layers so their first forward() doesn't re-draw over the
    # loaded weights
    @property
    def _is_init(self):
        return self.fwd._is_init and self.bwd._is_init

    @_is_init.setter
    def _is_init(self, value):
        self.fwd._is_init = value
        self.bwd._is_init = value

    def init_params(self, input_shape):
        self.fwd.init_params(input_shape)
        out = self.bwd.init_params(input_shape)
        return tuple(out[:-1]) + (2 * out[-1],)

    def set_phase(self, phase):
        self.fwd.set_phase(phase)
        self.bwd.set_phase(phase)
        super().set_phase(phase)

    def forward(self, inputs):
        out_f = self.fwd.forward(inputs)
        out_b = self.bwd.forward(inputs)
        return ops.concat_([out_f, out_b], axis=-1)


class BatchNorm(Layer):
    """Batch normalization over the batch (and, for NHWC inputs, spatial)
    axes with learned per-feature gamma/beta (ops.batch_norm_, hand VJPs).

    State model (functional-core-friendly): TRAIN always normalizes by the
    CURRENT batch statistics, and the running mean/var EMA (for TEST) is a
    pure function of (old buffers, batch stats) starting from mean=0/var=1
    (torch-style), so the SAME update runs eagerly and under a jit trace.
    Eager forwards commit the new values to ``self.buffers`` directly;
    traced forwards stash them in ``_new_buffers`` for the fused step to
    collect and return as outputs (``Net.collect_buffer_updates``) — the
    buffers thread through ``train_step``/``train_epochs`` like params and
    optimizer state, so fused-trained models reach TEST with the same
    running statistics as an eager-trained twin.
    No reference counterpart."""

    def __init__(self, dim=None, eps=1e-5, momentum=0.1,
                 gamma_init=None, beta_init=None):
        super().__init__("BatchNorm")
        self.eps = eps
        self.momentum = momentum
        self.initializers = {
            "gamma": gamma_init if gamma_init is not None else OnesInit(),
            "beta": beta_init if beta_init is not None else ZerosInit(),
        }
        self.shapes = {"gamma": [1, dim], "beta": [1, dim]}
        self.params = {"gamma": None, "beta": None}
        self.buffers = {"mean": None, "var": None, "count": None}
        self._is_init = False
        if dim is not None:
            self._init_parameters(dim)

    @property
    def is_init(self):
        return self._is_init

    def forward(self, inputs):
        import jax

        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        axes = tuple(range(inputs.data.ndim - 1))  # all but features
        if self.is_training:
            out, mu, var = ops.batch_norm_(
                inputs, self.params["gamma"], self.params["beta"],
                axes=axes, eps=self.eps)
            m = self.momentum
            # torch-style EMA: normalization uses the biased batch variance,
            # but the RUNNING var tracks the unbiased (Bessel-corrected)
            # estimate, n/(n-1) — matching torch so a torch-trained twin's
            # TEST statistics line up at small batch sizes
            n = 1
            for a in axes:
                n *= inputs.shape[a]
            var_u = var * (n / (n - 1.0)) if n > 1 else var
            self._new_buffers = {
                "mean": (1 - m) * self.buffers["mean"] + m * mu,
                "var": (1 - m) * self.buffers["var"] + m * var_u,
                "count": self.buffers["count"] + 1.0,
            }
            if not isinstance(mu, jax.core.Tracer):
                # eager forward: commit immediately; traced forwards leave
                # the commit to the fused step via collect_buffer_updates
                self.buffers.update(self._new_buffers)
            return out

        # TEST: running stats if the EMA has EVER updated ("count" buffer
        # — training paths that don't thread buffers, e.g. the parallel
        # wrappers, leave it at 0), else fall back to batch statistics
        # (the classic degraded-but-sane behavior; mean=0/var=1 identity
        # normalization would be silently wrong).
        import jax.numpy as jnp

        count = self.buffers.get("count")

        def ema_out():
            inv = 1.0 / jnp.sqrt(self.buffers["var"] + self.eps)
            return ((inputs - self.buffers["mean"])
                    * (self.params["gamma"] * inv) + self.params["beta"])

        if count is None or (not isinstance(count, jax.core.Tracer)
                             and float(count) > 0):
            return ema_out()
        out_b, _, _ = ops.batch_norm_(
            inputs, self.params["gamma"], self.params["beta"],
            axes=axes, eps=self.eps)
        if not isinstance(count, jax.core.Tracer):
            return out_b
        # traced count (buffers passed as jit args): select at runtime
        flag = (count > 0).astype(jnp.float32)
        return ema_out() * flag + out_b * (1.0 - flag)

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return tuple(input_shape)

    def _init_parameters(self, dim):
        import jax.numpy as jnp

        self.shapes = {"gamma": [1, int(dim)], "beta": [1, int(dim)]}
        self.params["gamma"] = self.initializers["gamma"](self.shapes["gamma"])
        self.params["beta"] = self.initializers["beta"](self.shapes["beta"])
        # torch-style EMA start; a static structure lets the buffers ride
        # the scan carry of the fused epoch from step 0. "count" tracks
        # whether the EMA has ever updated, so TEST can fall back to batch
        # statistics when a training path never threaded buffers.
        self.buffers = {"mean": jnp.zeros((int(dim),), jnp.float32),
                        "var": jnp.ones((int(dim),), jnp.float32),
                        "count": jnp.zeros((), jnp.float32)}
        self._is_init = True


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out_size(size, k, s, pad_lo, pad_hi):
    return (size + pad_lo + pad_hi - k) // s + 1


def _same_pad(size, k, s):
    out = -(-size // s)  # ceil
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2D(Layer):
    """2-D convolution over NHWC inputs: XLA's convolution, or im2col +
    matmul.

    kernel: [KH, KW, C_in, C_out]; im2col is built from KH*KW STRIDED BASIC
    SLICES of the (padded) input concatenated along a new patch axis, and
    each slice's autograd VJP is a slice-add (so the backward col2im is
    pad-and-add rather than a general scatter). The patch matrix then
    contracts against the flattened kernel with the same matmul primitive
    as Dense (benchmark config #4: im2col matmul fwd/bwd). The reference has
    no conv layer (only its support ops: pad_, conv-aware get_fans).
    """

    def __init__(self, kernel, stride=1, padding="SAME",
                 w_init=None, b_init=None, impl="xla", seed=None,
                 compute_dtype=None):
        """kernel: (KH, KW, C_in, C_out) — C_in may be None for lazy init.

        impl: "xla" (default) runs the conv2d_ primitive whose fwd and both
        hand VJPs are single lax conv calls; "im2col" composes the conv
        from strided-slice patches + the matmul primitive (useful as a
        cross-check and where native convs are unavailable).

        compute_dtype: mixed precision exactly as in Dense — input and
        kernel cast at use, output flows in that dtype, f32 master params."""
        super().__init__("Conv2D")
        self.compute_dtype = compute_dtype
        self.kernel_shape = list(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.impl = impl
        self.initializers = {
            "w": w_init if w_init is not None else XavierUniformInit(),
            "b": b_init if b_init is not None else ZerosInit(),
        }
        self.shapes = {"w": self.kernel_shape,
                       "b": [1, self.kernel_shape[3]]}
        self.params = {"w": None, "b": None}
        self._seed = seed
        self._is_init = False
        if self.kernel_shape[2] is not None:
            self._init_parameters(self.kernel_shape[2])
        self._idx_cache = {}

    @property
    def is_init(self):
        return self._is_init

    def _init_parameters(self, c_in):
        from tinynn_autograd_tpu.core.tensor import Tensor

        self.kernel_shape[2] = int(c_in)
        kh, kw, _, c_out = self.kernel_shape
        self.shapes["w"] = self.kernel_shape
        # draw with the fan-correct 2-D shape (fan_in = KH*KW*C_in,
        # fan_out = C_out) and reshape to HWIO — get_fans can't infer fans
        # from an HWIO 4-D shape, and the draw is iid so reshaping
        # preserves the distribution
        with _init_scope(self._seed):
            flat = self.initializers["w"]((kh * kw * c_in, c_out))
            self.params["w"] = Tensor(
                flat.data.reshape(kh, kw, c_in, c_out), requires_grad=True)
            self.params["b"] = self.initializers["b"](self.shapes["b"])
        self._is_init = True

    def init_params(self, input_shape):
        n, h, w, _c = input_shape
        if not self._is_init:
            self._init_parameters(input_shape[3])
        kh, kw, _, co = self.kernel_shape
        (plo_h, phi_h), (plo_w, phi_w) = self._pads(h, w)
        oh = _conv_out_size(h, kh, self.stride[0], plo_h, phi_h)
        ow = _conv_out_size(w, kw, self.stride[1], plo_w, phi_w)
        return (n, oh, ow, co)

    def _pads(self, h, w):
        kh, kw, _, _ = self.kernel_shape
        sh, sw = self.stride
        if self.padding == "SAME":
            return _same_pad(h, kh, sh), _same_pad(w, kw, sw)
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        ph, pw = _pair(self.padding)
        return (ph, ph), (pw, pw)

    def forward(self, inputs):
        n, h, w, c = inputs.shape
        if not self._is_init:
            self._init_parameters(c)
        kh, kw, c_in, c_out = self.kernel_shape
        sh, sw = self.stride
        pad_h, pad_w = self._pads(h, w)
        oh = _conv_out_size(h, kh, sh, *pad_h)
        ow = _conv_out_size(w, kw, sw, *pad_w)

        cd = self.compute_dtype
        wk = _to_dtype(self.params["w"], cd)
        bk = _to_dtype(self.params["b"], cd)
        x = _to_dtype(inputs, cd)

        if self.impl == "xla":
            out = ops.conv2d_(x, wk, self.stride, (pad_h, pad_w))
            # conv accumulates f32; round once at the layer boundary
            return _to_dtype(out + bk.reshape((1, 1, 1, c_out)), cd)

        if pad_h != (0, 0) or pad_w != (0, 0):
            x = ops.pad(x, [(0, 0), pad_h, pad_w, (0, 0)])
        patches = _window_patches(x, n, oh, ow, kh, kw, sh, sw)
        cols_mat = patches.reshape((n * oh * ow, kh * kw * c_in))
        w_mat = wk.reshape((kh * kw * c_in, c_out))
        out = _to_dtype(cols_mat @ w_mat + bk, cd)
        return out.reshape((n, oh, ow, c_out))


def _window_patches(x, n, oh, ow, kh, kw, sh, sw):
    """im2col as KH*KW strided slices concatenated on a new patch axis:
    [N, Hp, Wp, C] -> [N, OH, OW, KH*KW, C], patch index = kh*KW + kw
    (matching kernel.reshape(KH*KW*C, F) flattening)."""
    c = x.shape[-1]
    slices = []
    for i in range(kh):
        for j in range(kw):
            sl = x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :]
            slices.append(sl.reshape((n, oh, ow, 1, c)))
    if len(slices) == 1:
        return slices[0]
    return ops.concat(slices, axis=3)


class MaxPool2D(Layer):
    """Max pooling over NHWC via the same strided-slice patch stack +
    reduce-max over the patch axis.

    Tie semantics follow the framework's reduce-max (every maximal element
    receives the full gradient), matching the reference's reduce-max VJP
    (reference: core/ops.py:225-230)."""

    def __init__(self, pool_size=2, stride=None, padding="VALID"):
        super().__init__("MaxPool2D")
        self.pool_size = _pair(pool_size)
        self.stride = _pair(stride) if stride is not None else self.pool_size
        self.padding = padding

    def _geometry(self, h, w):
        kh, kw = self.pool_size
        sh, sw = self.stride
        if self.padding == "SAME":
            pad_h, pad_w = _same_pad(h, kh, sh), _same_pad(w, kw, sw)
        else:
            pad_h, pad_w = (0, 0), (0, 0)
        oh = _conv_out_size(h, kh, sh, *pad_h)
        ow = _conv_out_size(w, kw, sw, *pad_w)
        return pad_h, pad_w, oh, ow

    def init_params(self, input_shape):
        n, h, w, c = input_shape
        _, _, oh, ow = self._geometry(h, w)
        return (n, oh, ow, c)

    def forward(self, inputs):
        n, h, w, c = inputs.shape
        pad_h, pad_w, oh, ow = self._geometry(h, w)
        x = inputs
        if pad_h != (0, 0) or pad_w != (0, 0):
            # pad with -inf so padding never wins the max
            x = ops.pad(x, [(0, 0), pad_h, pad_w, (0, 0)],
                        constant_values=-np.inf)
        return ops.maxpool2d_(x, self.pool_size, self.stride)


class Reshape(Layer):
    """Batch-preserving reshape: [N, ...] -> [N, *shape] (one ``-1``
    allowed, inferred from the element count). Pure layout — the tape's
    reshape_ VJP restores the input shape. Lets model builders compose
    layout changes without custom layers (e.g. ViT patchify: Conv2D
    [N, H', W', D] -> Reshape((-1, D)) -> [N, T, D] token sequence)."""

    def __init__(self, shape):
        super().__init__("Reshape")
        self.target = tuple(int(s) for s in shape)
        if sum(1 for s in self.target if s == -1) > 1:
            raise ValueError("at most one -1 in shape, got %r"
                             % (self.target,))

    def _resolve(self, in_shape):
        n_elems = int(np.prod(in_shape[1:]))
        if -1 not in self.target:
            return self.target
        known = int(np.prod([s for s in self.target if s != -1]))
        return tuple(n_elems // known if s == -1 else s
                     for s in self.target)

    def init_params(self, input_shape):
        return (input_shape[0],) + self._resolve(tuple(input_shape))

    def forward(self, inputs):
        return inputs.reshape(
            (inputs.shape[0],) + self._resolve(inputs.shape))


class Flatten(Layer):
    """[N, ...] -> [N, prod(...)]."""

    def __init__(self):
        super().__init__("Flatten")

    def init_params(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))

    def forward(self, inputs):
        n = inputs.shape[0]
        return inputs.reshape((n, int(np.prod(inputs.shape[1:]))))


class Dropout(Layer):
    """Inverted dropout; identity in TEST phase.

    Under the fused jitted train step the mask key is threaded by the Model
    (folded from the step counter) via ``set_rng``, so each compiled step
    draws a fresh mask; eagerly it pulls from the global seeder stream.
    """

    def __init__(self, rate=0.5):
        super().__init__("Dropout")
        self.rate = rate
        self._rng = None

    def set_rng(self, rng):
        self._rng = rng

    def forward(self, inputs):
        if not self.is_training or self.rate == 0.0:
            return inputs
        rng = self._rng if self._rng is not None else seeder.next_key()
        self._rng = None
        return ops.dropout_(inputs, self.rate, rng)


class DenseStack(Layer):
    """``depth`` homogeneous Dense(width->width)+activation layers with
    STACKED parameters (w: [depth, W, W], b: [depth, 1, W]) executed as one
    scan primitive (ops.dense_stack_).

    This is the deep-network fast path: a 100-layer body compiles to two
    on-device scan kernels (forward + reverse) per training step instead of
    hundreds of per-layer kernels, and the optimizer updates two stacked
    leaves. Numerics are identical to the equivalent stack of Dense layers.
    """

    def __init__(self, depth, width=None, activation="relu", w_init=None,
                 b_init=None, seed=None):
        super().__init__("DenseStack")
        self.depth = depth
        self.width = width
        self.activation = activation
        self._seed = seed
        self.initializers = {
            "w": w_init if w_init is not None else XavierUniformInit(),
            "b": b_init if b_init is not None else ZerosInit(),
        }
        self.shapes = {"w": [depth, width, width], "b": [depth, 1, width]}
        self.params = {"w": None, "b": None}
        self._is_init = False
        if width is not None:
            self._init_parameters(width)

    @property
    def is_init(self):
        return self._is_init

    def _init_parameters(self, width):
        from tinynn_autograd_tpu.core.tensor import Tensor

        self.width = int(width)
        self.shapes = {"w": [self.depth, self.width, self.width],
                       "b": [self.depth, 1, self.width]}
        # per-layer draws with the correct 2-D fans, stacked
        with _init_scope(self._seed):
            ws = [self.initializers["w"]((self.width, self.width)).data
                  for _ in range(self.depth)]
            bs = [self.initializers["b"]((1, self.width)).data
                  for _ in range(self.depth)]
        import jax.numpy as jnp

        self.params = {
            "w": Tensor(jnp.stack(ws), requires_grad=True),
            "b": Tensor(jnp.stack(bs), requires_grad=True),
        }
        self._is_init = True

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return (input_shape[0], self.width)

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return ops.dense_stack_(inputs, self.params["w"], self.params["b"],
                                activation=self.activation)


class Activation(Layer):
    """Stateless elementwise layer (reference contract:
    core/layers.py:60-71)."""

    def __init__(self, name):
        super().__init__(name)

    def forward(self, inputs):
        return self.func(inputs)

    def func(self, x):
        raise NotImplementedError


class Sigmoid(Activation):

    def __init__(self):
        super().__init__("Sigmoid")

    def func(self, x):
        return ops.sigmoid(x)


class Tanh(Activation):

    def __init__(self):
        super().__init__("Tanh")

    def func(self, x):
        return ops.tanh(x)


class ReLU(Activation):

    def __init__(self):
        super().__init__("ReLU")

    def func(self, x):
        return ops.relu(x)


class LeakyReLU(Activation):

    def __init__(self, negative_slope=0.01):
        super().__init__("LeakyReLU")
        self._slope = negative_slope

    def func(self, x):
        return ops.leaky_relu(x, self._slope)


class GELU(Activation):

    def __init__(self):
        super().__init__("GELU")

    def func(self, x):
        return ops.gelu(x)


class Softplus(Activation):

    def __init__(self):
        super().__init__("Softplus")

    def func(self, x):
        return ops.softplus(x)


class Remat(Layer):
    """Activation-checkpoint wrapper: run ``inner`` WITHOUT keeping its
    tape; re-run it from its input during the backward (ops/remat.py).

    Wrap each block of a deep stack to make activation memory O(1) in
    depth instead of O(depth) — the classic per-block checkpointing
    pattern for long-context transformers and deep MLPs::

        Net([Remat(TransformerBlock(dim, heads)) for _ in range(depth)]
            + [Dense(n_out)])

    The wrapped layer's parameters remain first-class citizens of the
    Net (``params`` forwards to the inner layer), so optimizers,
    checkpointing, and ``collect_grads`` see them unchanged; their
    gradients are accumulated by the inner tape walk during the
    recompute. Stochastic inner layers replay EXACTLY: the wrapper
    snapshots the per-step rng (threaded by the Model, or a fresh
    global-seeder subkey eagerly) and re-injects it for the recompute,
    so both passes draw identical dropout masks.

    In TEST phase (no backward coming) the wrapper is a transparent
    pass-through. ``train_epochs`` runs the remat step under lax.scan
    like any other.

    Parallel wrappers: DataParallel composes fully (the recompute traces
    inside the shard_map step; parity-tested). TensorParallel and
    PipelineParallel treat a wrapped layer as an opaque REPLICATED layer
    — numerics are unchanged but it will not be col/row- or
    head-sharded, so don't wrap the layers you want sharded.

    No reference counterpart: the reference tape unconditionally stores
    every intermediate (reference core/ops.py:12-29).
    """

    def __init__(self, inner):
        # no super().__init__: ``params`` is a forwarding property here,
        # and the base would assign an instance dict over it
        self.name = "Remat(%s)" % inner.name
        self.grads = {}
        self.is_training = True
        self.inner = inner
        self._rng = None
        if hasattr(inner, "set_rng"):
            self.set_rng = self._set_rng

    def _set_rng(self, rng):
        self._rng = rng

    # ------------------------------------------------ forwarded state

    @property
    def params(self):
        return self.inner.params

    @params.setter
    def params(self, value):
        self.inner.params = value

    @property
    def buffers(self):
        b = getattr(self.inner, "buffers", None)
        if b is None:
            raise AttributeError("buffers")
        return b

    @property
    def _new_buffers(self):
        b = getattr(self.inner, "_new_buffers", None)
        if b is None:
            raise AttributeError("_new_buffers")
        return b

    @property
    def is_init(self):
        return self.inner.is_init

    def init_params(self, input_shape):
        fn = getattr(self.inner, "init_params", None)
        return tuple(fn(input_shape)) if fn is not None else tuple(input_shape)

    def set_phase(self, phase):
        self.is_training = phase == "TRAIN"
        self.inner.set_phase(phase)

    # ---------------------------------------------------------- forward

    def forward(self, inputs):
        inner = self.inner
        if not self.is_training:
            return inner.forward(inputs)
        rng = self._rng
        self._rng = None
        # pin the recompute's seeder draws: both runs of ``run`` must see
        # the SAME stream so an UNTHREADED stochastic inner (eager
        # dropout with no set_rng key delivered) replays identical masks.
        # Only drawn in that case — under a jit trace the Model always
        # threads rng to stochastic layers, and splitting the global key
        # during a trace would leak a tracer into the seeder.
        stochastic = hasattr(inner, "set_rng")
        key = seeder.next_key() if (stochastic and rng is None) else None

        def run(x):
            if rng is not None:
                inner.set_rng(rng)
            if key is None:
                return inner.forward(x)
            with seeder.scope(key):
                return inner.forward(x)

        from tinynn_autograd_tpu.ops.remat import remat_

        return remat_(run, inputs)
