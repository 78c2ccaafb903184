"""Fused (flash-style) multi-head attention kernels: forward + backward.

The tape's generic attention path (TransformerBlock, nn/layers.py) is four
tape primitives — batched dot_, softmax_, dot_ — whose XLA lowering
materializes the [B, H, T, T] score/probability tensors in device memory
in both directions. These kernels compute softmax(Q K^T * scale [+ causal
mask]) V with the ONLINE-softmax recurrence (Flash Attention 2): scores
live only in registers and shared memory one [bq, bk] tile at a time, and
device memory sees just Q/K/V/O plus a per-row logsumexp — O(T) memory
instead of O(T^2).

Backward is the standard recompute scheme, hand-derived (NO jax.grad — this
is a tape primitive like everything else, see ops.primitives.flash_attention_):

    D_i   = sum_d dO_id O_id
    p_ij  = exp(s_ij - L_i)                 (L = logsumexp, saved fwd)
    dV_j  = sum_i p_ij dO_i
    dp_ij = dO_i . V_j
    ds_ij = p_ij (dp_ij - D_i) * scale
    dQ_i  = sum_j ds_ij K_j
    dK_j  = sum_i ds_ij Q_i

run as two kernels (dQ over query blocks, dK/dV over key blocks) so each
output block is written by exactly one program — no atomics.

The kernels are written for Pallas's Triton route (``backend="triton"``):
one program per (query or key block, head); the sequential sweep over the
other axis is a ``fori_loop`` inside the program whose BOUNDS skip the
tiles that the causal mask or the sliding window hide. Grouped-query
attention is native: a query head's program reads its kv head's K/V
(index ``head // group``), and the dK/dV program sums over its group.
Tile edges are powers of two chosen from the shape; ragged lengths and head
dims are zero-padded by the wrappers (padded keys are masked, padded query
rows carry a zero cotangent).

Dispatch: the kernels on the GPU above the measured crossover
(``_KERNEL_MIN_T``), interpret mode for CPU tests, and a pure-XLA twin
implementing the identical math (including the saved logsumexp and the
dropout masks) everywhere else. No reference counterpart (the reference
has no attention); the tape contract it plugs into is ops.primitives.
"""

import contextlib
import contextvars
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tinynn_autograd_tpu.ops import kernels

_NEG_INF = -1e30


def band_mask(t, window):
    """Static [t, t] boolean visibility mask: causal, optionally banded
    to the sliding window (position p sees keys in (p - window, p]).
    THE shared band-mask constructor — the XLA twin, the layers' tape masks,
    and the decode prefill all use it, so the window semantics cannot
    desynchronize between training, fallback, and serving."""
    m = np.tril(np.ones((t, t), np.bool_))
    if window is not None and window < t:
        m &= ~np.tril(np.ones((t, t), np.bool_), -int(window))
    return m


# ------------------------------------------------------- dropout machinery
#
# Attention-probability dropout with NO stored mask: the keep/drop decision
# for probability p[h, qi, kj] is a pure counter-hash of the ABSOLUTE
# (query head, query, key) index and a per-call seed, so the forward kernel,
# both recompute-backward kernels, and the XLA twin all regenerate the
# identical mask independently — no [B, H, T, T] bits in device memory.
# A murmur3-style finalizer over uint32 integers (the same construction as
# ops.primitives._hash_bits_u32); dropout needs i.i.d.-looking bits, not
# crypto.
#
# Math: with P = softmax(S) and M the keep mask, O = (M ∘ P / keep) V.
# Only the P-V product is masked — the online-softmax normalizer l still
# sums the UNMASKED p̃, and the backward's delta term is unchanged:
# D_i = Σ_k dp_ik p_ik = dO_i · O_i exactly as in the no-dropout scheme.
# The per-tile backward factors become
#     ds_ij = p_ij (m_ij (dO_i·V_j)/keep − D_i) scale
#     dV_j  = Σ_i (m_ij p_ij / keep) dO_i.

def _keep_mask(seed, head, qi, ki, tq, tk, thresh):
    """Keep decisions for the (head, qi, ki) index triples (uint32 arrays
    that broadcast together): True where the probability survives."""
    x = (head * jnp.uint32(tq) + qi) * jnp.uint32(tk) + ki
    x = x + seed * jnp.uint32(2654435761)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x < thresh


def _keep_thresh(rate):
    return jnp.uint32(int((1.0 - rate) * (2 ** 32 - 1)))


def plane_keep_mask(seed, n_heads, tq, tk, rate):
    """[n_heads, tq, tk] keep mask — the same per-(head, q, k) hash the
    kernels replay tile by tile, over the whole plane. ``n_heads`` counts
    query heads (B * H, batch-major)."""
    shape = (n_heads, tq, tk)
    idx = [jax.lax.broadcasted_iota(jnp.uint32, shape, a) for a in range(3)]
    return _keep_mask(jnp.asarray(seed, jnp.uint32), idx[0], idx[1], idx[2],
                      tq, tk, _keep_thresh(rate))


# ------------------------------------------------------------ tile choice

def _edge(t, pref):
    """Power-of-two tile edge: ``pref`` or the padded length when shorter,
    never below 16 (the smallest operand Triton's dot takes)."""
    return max(16, min(pref, pl.next_power_of_2(t)))


# Tile choices, from bench_attention.py --sweep on an H100 (400 W limit),
# float32 at d=64, seq 128 / 1024 / 2048: forward (128, 64) with 8 warps
# ran within 5% of the best of nine candidates at 1024 and 2048 and was
# the best at 128; the backward's (64, 32) with 4 warps was the best at
# 1024 and 2048. Wider head dims halve the key tile so the staged K/V
# tiles stay inside the 227 KB of shared memory a block may use (the
# (128, 64) backward at d=64 already asked for 263 KB and was refused).

def _fwd_tiles(tq, tk, d):
    """(bq, bk, num_warps, num_stages) of the forward kernel."""
    return _edge(tq, 128), _edge(tk, 64 if d <= 64 else 32), 8, 3


def _bwd_tiles(tq, tk, d):
    """(bq, bk, num_warps, num_stages) shared by the dQ and dK/dV kernels."""
    return _edge(tq, 64 if d <= 64 else 32), _edge(tk, 32), 4, 2


def _round_up(x, m):
    return -(-x // m) * m


def _padded(tq, tk, bq, bk, causal):
    """Whole-tile lengths. Causal attention pads both axes to one length
    (a multiple of both edges) so the diagonal's key blocks all exist."""
    if causal:
        t = _round_up(tq, max(bq, bk))
        return t, t
    return _round_up(tq, bq), _round_up(tk, bk)


def _pad_to(x, axis, size):
    if x.shape[axis] == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, pad)


# --------------------------------------------------------- kernel helpers

def _visible(s, rows, cols, causal, window, tk, tk_pad):
    """Mask one score tile: causal band, sliding window, and the padded
    keys at and beyond ``tk`` when the key axis was padded to ``tk_pad``."""
    vis = None
    if causal:
        vis = rows >= cols
        if window is not None:
            vis = vis & (rows - cols < window)
    if tk < tk_pad:
        pad_ok = cols < tk
        vis = pad_ok if vis is None else vis & pad_ok
    return s if vis is None else jnp.where(vis, s, _NEG_INF)


def _key_blocks(i, bq, bk, nk, causal, window):
    """[lo, hi) key-block range that query block ``i`` can see."""
    if not causal:
        return 0, nk
    hi = jax.lax.div((i + 1) * bq + bk - 1, bk)
    lo = 0
    if window is not None:
        lo = jax.lax.div(jnp.maximum(i * bq - window + 1, 0), bk)
    return lo, hi


def _query_blocks(j, bq, bk, nq, causal, window):
    """[lo, hi) query-block range that can see key block ``j``."""
    if not causal:
        return 0, nq
    lo = jax.lax.div(j * bk, bq)
    hi = nq
    if window is not None:
        hi = jnp.minimum(
            jax.lax.div(j * bk + bk - 1 + window - 1 + bq, bq), nq)
    return lo, hi


def _kernel_precision(dtype, interpret):
    """The precision the kernels' dots state. float32 operands on the GPU
    take three TF32 tensor-core passes (TF32x3: the operands split into a
    TF32 head and tail, float32-accurate products); plain IEEE float32
    dots measured 3-10x slower than the XLA twin on the H100, with
    register spills at the wider tiles. The CPU interpreter has no TF32x3
    and runs HIGHEST (exact float32)."""
    if jnp.dtype(dtype) != jnp.float32:
        return None
    if interpret:
        return jax.lax.Precision.HIGHEST
    return jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _call(kernel, grid, in_specs, out_specs, out_shape, warps, stages,
          interpret, name):
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=warps,
                                                 num_stages=stages),
        interpret=interpret, name=name)


def _seed_arr(seed):
    """Dropout seed as a (1,) uint32 operand (0 when unused)."""
    return jnp.asarray(0 if seed is None else seed,
                       jnp.uint32).reshape(1)


# --------------------------------------------------------------- forward

def _fwd_kernel(seed_ref, q_ref, k_ref, v_ref, o_ref, lse_ref, *, scale,
                causal, window, bq, bk, nk, tq, tk, tk_pad, dropout,
                precision):
    i, h = pl.program_id(0), pl.program_id(1)
    q = q_ref[...]                                     # [bq, d]
    rows = i * bq + jnp.arange(bq)[:, None]
    lo, hi = _key_blocks(i, bq, bk, nk, causal, window)
    inv = 1.0 / (1.0 - dropout) if dropout > 0.0 else 1.0

    def body(j, carry):
        acc, m, l = carry
        start = pl.multiple_of(j * bk, bk)
        k = k_ref[pl.ds(start, bk), :]
        v = v_ref[pl.ds(start, bk), :]
        cols = start + jnp.arange(bk)[None, :]
        s = pl.dot(q, k, trans_b=True, precision=precision) * scale
        s = _visible(s, rows, cols, causal, window, tk, tk_pad)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[:, None])
        l = l * alpha + jnp.sum(p, axis=1)
        if dropout > 0.0:
            # mask the P·V accumulation only — the softmax normalizer
            # keeps summing the unmasked p (see dropout machinery note)
            keep = _keep_mask(seed_ref[0], h.astype(jnp.uint32),
                              rows.astype(jnp.uint32),
                              cols.astype(jnp.uint32), tq, tk,
                              _keep_thresh(dropout))
            p = jnp.where(keep, p, 0.0) * inv
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v,
                                            precision=precision)
        return acc, m_new, l

    acc, m, l = jax.lax.fori_loop(
        lo, hi, body,
        (jnp.zeros(q.shape, jnp.float32),
         jnp.full((bq,), _NEG_INF, jnp.float32),
         jnp.zeros((bq,), jnp.float32)))
    o_ref[...] = (acc / l[:, None]).astype(o_ref.dtype)
    lse_ref[...] = m + jnp.log(l)


def _fwd_triton(q, k, v, group, scale, causal, window, dropout, seed,
                interpret):
    """q [BH, Tq, d], k/v [BH/group, Tk, d] -> (o [BH, Tq, d],
    lse [BH, Tq] f32)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dp = max(16, pl.next_power_of_2(d))
    bq, bk, warps, stages = _fwd_tiles(tq, tk, dp)
    tq_pad, tk_pad = _padded(tq, tk, bq, bk, causal)
    qp = _pad_to(_pad_to(q, 1, tq_pad), 2, dp)
    kp = _pad_to(_pad_to(k, 1, tk_pad), 2, dp)
    vp = _pad_to(_pad_to(v, 1, tk_pad), 2, dp)
    kern = functools.partial(
        _fwd_kernel, scale=scale, causal=causal, window=window, bq=bq,
        bk=bk, nk=tk_pad // bk, tq=tq, tk=tk, tk_pad=tk_pad, dropout=dropout,
        precision=_kernel_precision(q.dtype, interpret))
    kv_spec = pl.BlockSpec((None, tk_pad, dp), lambda i, h: (h // group, 0, 0))
    o, lse = _call(
        kern, (tq_pad // bq, bh),
        [pl.BlockSpec((1,), lambda i, h: (0,)),
         pl.BlockSpec((None, bq, dp), lambda i, h: (h, i, 0)),
         kv_spec, kv_spec],
        [pl.BlockSpec((None, bq, dp), lambda i, h: (h, i, 0)),
         pl.BlockSpec((None, bq), lambda i, h: (h, i))],
        [jax.ShapeDtypeStruct((bh, tq_pad, dp), q.dtype),
         jax.ShapeDtypeStruct((bh, tq_pad), jnp.float32)],
        warps, stages, interpret, "flash_attention_fwd",
    )(_seed_arr(seed), qp, kp, vp)
    return o[:, :tq, :d], lse[:, :tq]


# -------------------------------------------------------------- backward

def _dq_kernel(seed_ref, q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref,
               dq_ref, *, scale, causal, window, bq, bk, nk, tq, tk,
               tk_pad, dropout, precision):
    i, h = pl.program_id(0), pl.program_id(1)
    q = q_ref[...]
    do = do_ref[...]
    lse = lse_ref[...][:, None]
    delta = delta_ref[...][:, None]
    rows = i * bq + jnp.arange(bq)[:, None]
    lo, hi = _key_blocks(i, bq, bk, nk, causal, window)
    inv = 1.0 / (1.0 - dropout) if dropout > 0.0 else 1.0

    def body(j, dq):
        start = pl.multiple_of(j * bk, bk)
        k = k_ref[pl.ds(start, bk), :]
        v = v_ref[pl.ds(start, bk), :]
        cols = start + jnp.arange(bk)[None, :]
        s = pl.dot(q, k, trans_b=True, precision=precision) * scale
        s = _visible(s, rows, cols, causal, window, tk, tk_pad)
        p = jnp.exp(s - lse)
        dp = pl.dot(do, v, trans_b=True, precision=precision)
        if dropout > 0.0:
            # replay the forward's keep decisions (same hash of the
            # absolute indices); ds = p (m dp/keep − D) scale
            keep = _keep_mask(seed_ref[0], h.astype(jnp.uint32),
                              rows.astype(jnp.uint32),
                              cols.astype(jnp.uint32), tq, tk,
                              _keep_thresh(dropout))
            dp = jnp.where(keep, dp, 0.0) * inv
        ds = p * (dp - delta) * scale
        return dq + pl.dot(ds.astype(k.dtype), k, precision=precision)

    dq = jax.lax.fori_loop(lo, hi, body, jnp.zeros(q.shape, jnp.float32))
    dq_ref[...] = dq.astype(dq_ref.dtype)


def _dkv_kernel(seed_ref, q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref,
                dk_ref, dv_ref, *, scale, causal, window, bq, bk, nq, group,
                tq, tk, tk_pad, dropout, precision):
    """One key block of one kv head: sweeps the visible query blocks of
    every query head in its GQA group, accumulating dK/dV in registers."""
    j, c = pl.program_id(0), pl.program_id(1)
    k = k_ref[...]                                     # [bk, d]
    v = v_ref[...]
    cols = j * bk + jnp.arange(bk)[None, :]
    lo, hi = _query_blocks(j, bq, bk, nq, causal, window)
    inv = 1.0 / (1.0 - dropout) if dropout > 0.0 else 1.0

    def head_body(g, carry):
        head = (c * group + g).astype(jnp.uint32)

        def body(i, carry):
            dk, dv = carry
            start = pl.multiple_of(i * bq, bq)
            q = q_ref[g, pl.ds(start, bq), :]
            do = do_ref[g, pl.ds(start, bq), :]
            lse = lse_ref[g, pl.ds(start, bq)][:, None]
            delta = delta_ref[g, pl.ds(start, bq)][:, None]
            rows = start + jnp.arange(bq)[:, None]
            s = pl.dot(q, k, trans_b=True, precision=precision) * scale
            s = _visible(s, rows, cols, causal, window, tk, tk_pad)
            p = jnp.exp(s - lse)
            dp = pl.dot(do, v, trans_b=True, precision=precision)
            if dropout > 0.0:
                keep = _keep_mask(seed_ref[0], head,
                                  rows.astype(jnp.uint32),
                                  cols.astype(jnp.uint32), tq, tk,
                                  _keep_thresh(dropout))
                pd = jnp.where(keep, p, 0.0) * inv
                dp = jnp.where(keep, dp, 0.0) * inv
            else:
                pd = p
            dv = dv + pl.dot(pd.astype(do.dtype), do, trans_a=True,
                             precision=precision)
            ds = p * (dp - delta) * scale
            dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True,
                             precision=precision)
            return dk, dv

        return jax.lax.fori_loop(lo, hi, body, carry)

    zeros = jnp.zeros(k.shape, jnp.float32)
    dk, dv = jax.lax.fori_loop(0, group, head_body, (zeros, zeros))
    dk_ref[...] = dk.astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _bwd_triton(q, k, v, do, lse, delta, group, scale, causal, window,
                dropout, seed, interpret):
    """q/do [BH, Tq, d], k/v [BH/group, Tk, d], lse/delta [BH, Tq] ->
    (dq, dk, dv) in the operands' shapes."""
    bh, tq, d = q.shape
    nkv, tk = k.shape[0], k.shape[1]
    dp = max(16, pl.next_power_of_2(d))
    bq, bk, warps, stages = _bwd_tiles(tq, tk, dp)
    tq_pad, tk_pad = _padded(tq, tk, bq, bk, causal)
    qp = _pad_to(_pad_to(q, 1, tq_pad), 2, dp)
    dop = _pad_to(_pad_to(do, 1, tq_pad), 2, dp)
    kp = _pad_to(_pad_to(k, 1, tk_pad), 2, dp)
    vp = _pad_to(_pad_to(v, 1, tk_pad), 2, dp)
    lsep = _pad_to(lse, 1, tq_pad)
    deltap = _pad_to(delta, 1, tq_pad)
    nq, nk = tq_pad // bq, tk_pad // bk
    common = dict(scale=scale, causal=causal, window=window, bq=bq, bk=bk,
                  tq=tq, tk=tk, tk_pad=tk_pad, dropout=dropout,
                  precision=_kernel_precision(q.dtype, interpret))
    seed_spec = pl.BlockSpec((1,), lambda a, b: (0,))

    kv_full = pl.BlockSpec((None, tk_pad, dp), lambda i, h: (h // group, 0, 0))
    q_blk = pl.BlockSpec((None, bq, dp), lambda i, h: (h, i, 0))
    row_blk = pl.BlockSpec((None, bq), lambda i, h: (h, i))
    dq = _call(
        functools.partial(_dq_kernel, nk=nk, **common), (nq, bh),
        [seed_spec, q_blk, kv_full, kv_full, q_blk, row_blk, row_blk],
        q_blk, jax.ShapeDtypeStruct((bh, tq_pad, dp), q.dtype),
        warps, stages, interpret, "flash_attention_dq",
    )(_seed_arr(seed), qp, kp, vp, dop, lsep, deltap)

    # dK/dV: one program per (key block, kv head); the group's query heads
    # are one block [group, Tq, d] of the [BH/group, group, Tq, d] view
    q_grp = pl.BlockSpec((None, group, tq_pad, dp), lambda j, c: (c, 0, 0, 0))
    row_grp = pl.BlockSpec((None, group, tq_pad), lambda j, c: (c, 0, 0))
    kv_blk = pl.BlockSpec((None, bk, dp), lambda j, c: (c, j, 0))
    dk, dv = _call(
        functools.partial(_dkv_kernel, nq=nq, group=group, **common),
        (nk, nkv),
        [seed_spec, q_grp, kv_blk, kv_blk, q_grp, row_grp, row_grp],
        [kv_blk, kv_blk],
        [jax.ShapeDtypeStruct((nkv, tk_pad, dp), k.dtype),
         jax.ShapeDtypeStruct((nkv, tk_pad, dp), v.dtype)],
        warps, stages, interpret, "flash_attention_dkv",
    )(_seed_arr(seed), qp.reshape(nkv, group, tq_pad, dp), kp, vp,
      dop.reshape(nkv, group, tq_pad, dp),
      lsep.reshape(nkv, group, tq_pad), deltap.reshape(nkv, group, tq_pad))
    return dq[:, :tq, :d], dk[:, :tk, :d], dv[:, :tk, :d]


# ------------------------------------------------------------- XLA twin
#
# Same math on the [N, G, T, d] grouped view (N = B * Hkv kv heads, G query
# heads per kv head): the scores DO materialize here; this is the
# correctness twin and the path below the kernels' crossover.

def _scores(q, k, scale, causal, window):
    s = jnp.einsum("ngqd,nkd->ngqk", q, k,
                   preferred_element_type=jnp.float32,
                   precision=kernels.dot_precision(q.dtype)) * scale
    if causal:
        s = jnp.where(band_mask(q.shape[2], window), s, _NEG_INF)
    return s


def _twin_keep(seed, q, tk, dropout):
    n, g, tq = q.shape[:3]
    return plane_keep_mask(seed, n * g, tq, tk, dropout).reshape(
        n, g, tq, tk)


def _fwd_xla(q, k, v, scale, causal, dropout, seed, window):
    prec = kernels.dot_precision(q.dtype)
    s = _scores(q, k, scale, causal, window)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    if dropout > 0.0:
        keep = _twin_keep(seed, q, k.shape[1], dropout)
        p = jnp.where(keep, p, 0.0) * (1.0 / (1.0 - dropout))
    o = jnp.einsum("ngqk,nkd->ngqd", p.astype(v.dtype), v,
                   preferred_element_type=jnp.float32, precision=prec) / l
    return o.astype(q.dtype), (m + jnp.log(l))[..., 0]


def _bwd_xla(q, k, v, do, lse, delta, scale, causal, dropout, seed, window):
    prec = kernels.dot_precision(q.dtype)
    s = _scores(q, k, scale, causal, window)
    p = jnp.exp(s - lse[..., None])
    dp = jnp.einsum("ngqd,nkd->ngqk", do, v,
                    preferred_element_type=jnp.float32, precision=prec)
    if dropout > 0.0:
        keep = _twin_keep(seed, q, k.shape[1], dropout)
        inv = 1.0 / (1.0 - dropout)
        pd = jnp.where(keep, p, 0.0) * inv
        dp = jnp.where(keep, dp, 0.0) * inv
    else:
        pd = p
    dv = jnp.einsum("ngqk,ngqd->nkd", pd.astype(q.dtype), do,
                    preferred_element_type=jnp.float32, precision=prec)
    ds = (p * (dp - delta[..., None]) * scale).astype(q.dtype)
    dq = jnp.einsum("ngqk,nkd->ngqd", ds, k,
                    preferred_element_type=jnp.float32, precision=prec)
    dk = jnp.einsum("ngqk,ngqd->nkd", ds, q,
                    preferred_element_type=jnp.float32, precision=prec)
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


# ---------------------------------------------------------------- dispatch

# Shortest sequence at which the kernels beat the XLA twin end to end on
# the GPU. chip_smoke.py phase 5 on an H100 (700 W limit), float32
# train_step: llama seq 1024 60.2 ms with the kernels vs 65.8 ms with the
# twin, transformer seq 2048 21.2 vs 25.0 ms — but the seq-128 classifier
# 25.1 vs 22.4 ms (the kernel lost there: fwd+bwd 360 vs 315 us). Between
# them only isolated timings exist (seq 512: 518 vs 554 us fwd+bwd on a
# 400 W H100), no cell, so the twin keeps those lengths.
_KERNEL_MIN_T = 1024
_HEAD_DIM_MAX = 128

_IMPL = contextvars.ContextVar("tinynn_attention_impl", default=None)


@contextlib.contextmanager
def use_impl(impl):
    """Trace every attention call inside the block with ``impl``
    ("pallas" | "pallas_interpret" | "xla"), as if each call passed it —
    how a whole model is compared kernel against twin."""
    tok = _IMPL.set(impl)
    try:
        yield
    finally:
        _IMPL.reset(tok)


def _resolve_impl(impl, t, d):
    """The path one call takes: an explicit ``impl``, else the kernels on
    the GPU for sequences of at least ``_KERNEL_MIN_T`` and head dims up to
    ``_HEAD_DIM_MAX``, else the XLA twin."""
    if impl is None:
        impl = _IMPL.get()
    if impl is not None:
        if impl not in ("pallas", "pallas_interpret", "xla"):
            raise ValueError("unknown attention impl %r" % (impl,))
        return impl
    if (jax.default_backend() == "gpu" and t >= _KERNEL_MIN_T
            and d <= _HEAD_DIM_MAX):
        return "pallas"
    return "xla"


def _norm_window(window, causal, t):
    """Validate/normalize sliding-window size: None passthrough, must be
    a positive int, requires the causal mask, and window >= t degenerates
    to plain causal attention (None)."""
    if window is None:
        return None
    if not causal:
        raise ValueError("sliding-window attention requires causal=True")
    window = int(window)
    if window < 1:
        raise ValueError("window must be >= 1, got %d" % window)
    return None if window >= t else window


def _check_heads(h, hkv):
    if h % hkv:
        raise ValueError("GQA needs kv heads (%d) to divide query heads (%d)"
                         % (hkv, h))
    return h // hkv


def mha_fwd(q, k, v, causal=False, scale=None, impl=None,
            dropout_rate=0.0, dropout_seed=None, window=None):
    """softmax(Q K^T * scale [+ causal mask]) V. Q: [B, H, Tq, d];
    K/V: [B, Hkv, Tk, d] (cross-attention allowed; ``causal`` requires
    Tq == Tk). Returns (o [B,H,Tq,d], lse [B,H,Tq,1] f32) — lse is the
    per-row logsumexp of the scaled scores, consumed by mha_bwd.

    GROUPED-QUERY ATTENTION: K/V may carry FEWER heads (Hkv | H; query
    head j reads kv head j // (H/Hkv)); the repeated K/V never
    materializes.

    ``dropout_rate``/``dropout_seed``: attention-probability dropout with
    an in-kernel counter-hash mask — no [T, T] mask tensor exists anywhere;
    mha_bwd replays the identical mask from the same (static rate, traced
    seed) pair. The seed is a uint32 scalar (python int or traced).

    ``window``: SLIDING-WINDOW attention (requires ``causal``): position
    p attends keys in (p - window, p]. The kernels visit only in-band
    tiles, so cost is O(T * window) instead of O(T^2); the XLA twin masks
    in place. ``window >= t`` is a no-op (dropped to None)."""
    b, h, t, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = _check_heads(h, hkv)
    if causal and tk != t:
        raise ValueError("causal attention requires Tq == Tk, got %d vs %d"
                         % (t, tk))
    window = _norm_window(window, causal, t)
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    dropout_rate = float(dropout_rate)
    impl = _resolve_impl(impl, max(t, tk), d)
    if impl == "xla":
        o, lse = _fwd_xla(q.reshape(b * hkv, group, t, d),
                          k.reshape(b * hkv, tk, d),
                          v.reshape(b * hkv, tk, d), scale, causal,
                          dropout_rate, dropout_seed, window)
    else:
        o, lse = _fwd_triton(q.reshape(b * h, t, d),
                             k.reshape(b * hkv, tk, d),
                             v.reshape(b * hkv, tk, d), group, scale,
                             causal, window, dropout_rate, dropout_seed,
                             interpret=(impl == "pallas_interpret"))
    return o.reshape(b, h, t, d), lse.reshape(b, h, t, 1)


def mha_bwd(q, k, v, o, lse, do, causal=False, scale=None, impl=None,
            dropout_rate=0.0, dropout_seed=None, window=None):
    """Hand-written VJP of mha_fwd (recompute scheme; see module docstring).
    Returns (dq, dk, dv) in the operands' shapes. Pass the SAME
    dropout_rate/dropout_seed/window as the forward — the keep mask and
    the band are replayed, never stored. Under GQA dk/dv sum over each kv
    head's query group — exactly the reduction a repeated-KV unbroadcast
    would perform."""
    b, h, t, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = _check_heads(h, hkv)
    window = _norm_window(window, causal, t)
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    dropout_rate = float(dropout_rate)
    impl = _resolve_impl(impl, max(t, tk), d)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    lse = lse.reshape(b, h, t)
    if impl == "xla":
        dq, dk, dv = _bwd_xla(
            q.reshape(b * hkv, group, t, d), k.reshape(b * hkv, tk, d),
            v.reshape(b * hkv, tk, d), do.reshape(b * hkv, group, t, d),
            lse.reshape(b * hkv, group, t), delta.reshape(b * hkv, group, t),
            scale, causal, dropout_rate, dropout_seed, window)
    else:
        dq, dk, dv = _bwd_triton(
            q.reshape(b * h, t, d), k.reshape(b * hkv, tk, d),
            v.reshape(b * hkv, tk, d), do.reshape(b * h, t, d),
            lse.reshape(b * h, t), delta.reshape(b * h, t), group, scale,
            causal, window, dropout_rate, dropout_seed,
            interpret=(impl == "pallas_interpret"))
    return (dq.reshape(b, h, t, d), dk.reshape(b, hkv, tk, d),
            dv.reshape(b, hkv, tk, d))
