"""Blockwise ring attention as ONE tape primitive (VERDICT r4 item 2).

``ring_flash_attention_`` computes exact softmax attention over a
SEQUENCE-SHARDED [B, H, T/n, d] layout inside a shard_map region: K/V
chunks rotate around the mesh ring (n-1 ``ppermute`` hops) and each
arriving chunk is consumed by the flash-attention kernels
(ops/attention.py) — per-hop partial outputs ``(o_s, lse_s)`` are combined
with the logsumexp algebra

    m        = max_s lse_s
    l        = sum_s exp(lse_s - m)
    O        = sum_s exp(lse_s - m) o_s / l
    lse_glob = m + log l

which is algebraically the one global softmax over the concatenated row.
Unlike the exact-concat scheme this never materializes a [T/n, T] score
block: per hop the kernels hold one [bq, bk] tile on chip (Triton) or a
transient [T/n, T/n] chunk (XLA twin), and across hops only the
O(T/n · d) running outputs persist — the true blockwise ring-attention
memory profile (Liu et al.'s ring attention; here with the flash kernels'
recompute backward per hop).

Backward is hand-written (tape primitive — NO jax.grad): the standard
flash decomposition holds chunk-wise against the GLOBAL (O, lse_glob) —
``mha_bwd(q, k_s, v_s, O, lse_glob, dO)`` yields that chunk's exact
dq-contribution and its dk_s/dv_s — and the dk/dv cotangents ride a
REVERSE ring (one backward ppermute per hop, accumulated in a carry) back
to their owner devices. Causal masking: hop 0 is the diagonal chunk
(static causal=True into the kernels); hop s>0 is either fully visible
(chunk owner behind this device) or fully masked — handled by zeroing
lse_s (forward) / the cotangents (backward) under the traced visibility
predicate, so shapes stay static.

Attention-probability dropout composes: each hop gets a distinct seed
derived from ``dropout_seed`` and the kernels replay their in-kernel hash
masks (ops/attention.py "dropout machinery") — the combine algebra is
unchanged because the masks only touch the P·V accumulation, never the
normalizer.
"""

import numpy as np

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.ops import attention

_NEG = -1e30


def _hop_seed(seed, s):
    if seed is None:
        return None
    return (jnp.asarray(seed).astype(jnp.uint32) * jnp.uint32(1000003)
            + jnp.uint32(s))


def ring_flash_attention_(ts_q, ts_k, ts_v, axis_name, n_devices,
                          causal=False, scale=None, impl=None,
                          dropout_rate=0.0, dropout_seed=None):
    """Blockwise ring attention over mesh axis ``axis_name``. Q/K/V are the
    LOCAL sequence chunks [B, H, T/n, d] inside shard_map; returns the
    local context chunk [B, H, T/n, d] with all three VJPs on the tape
    (dk/dv cotangents are ring-routed back to their owners)."""
    n = int(n_devices)
    q, k, v = ts_q.data, ts_k.data, ts_v.data
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    fwd_ring = [(i, (i + 1) % n) for i in range(n)]
    bwd_ring = [(i, (i - 1) % n) for i in range(n)]
    idx = jax.lax.axis_index(axis_name)

    # ---- forward: rotate K/V, consume each chunk blockwise --------------
    k_chunks, v_chunks, os_, lses = [], [], [], []
    kc, vc = k, v
    for s in range(n):
        k_chunks.append(kc)
        v_chunks.append(vc)
        o_s, lse_s = attention.mha_fwd(
            q, kc, vc, causal=(causal and s == 0), scale=scale, impl=impl,
            dropout_rate=dropout_rate,
            dropout_seed=_hop_seed(dropout_seed, s))
        if causal and s > 0:
            # chunk owner is (idx - s) mod n: for 0 < s < n it is visible
            # iff it sits strictly BEHIND this device (no wraparound)
            visible = idx >= s
            lse_s = jnp.where(visible, lse_s, _NEG)
        os_.append(o_s)
        lses.append(lse_s)
        if s < n - 1:
            kc = jax.lax.ppermute(kc, axis_name, fwd_ring)
            vc = jax.lax.ppermute(vc, axis_name, fwd_ring)

    m = lses[0]
    for lse_s in lses[1:]:
        m = jnp.maximum(m, lse_s)
    ws = [jnp.exp(lse_s - m) for lse_s in lses]
    l = ws[0]
    for w in ws[1:]:
        l = l + w
    o = sum(w * o_s for w, o_s in zip(ws, os_)) / l
    o = o.astype(q.dtype)
    lse_glob = m + jnp.log(l)

    # ---- backward: flash decomposition per chunk + reverse ring ---------
    cache = []  # [grad_object, (dq, dk, dv)]

    def joint_bwd(grad):
        dq = None
        carry_k = carry_v = None
        for s in range(n - 1, -1, -1):
            dq_s, dk_s, dv_s = attention.mha_bwd(
                q, k_chunks[s], v_chunks[s], o, lse_glob, grad,
                causal=(causal and s == 0), scale=scale, impl=impl,
                dropout_rate=dropout_rate,
                dropout_seed=_hop_seed(dropout_seed, s))
            if causal and s > 0:
                visible = idx >= s
                dq_s = jnp.where(visible, dq_s, 0.0).astype(dq_s.dtype)
                dk_s = jnp.where(visible, dk_s, 0.0).astype(dk_s.dtype)
                dv_s = jnp.where(visible, dv_s, 0.0).astype(dv_s.dtype)
            dq = dq_s if dq is None else dq + dq_s
            if carry_k is None:
                carry_k, carry_v = dk_s, dv_s
            else:
                carry_k = carry_k + dk_s
                carry_v = carry_v + dv_s
            if s > 0:
                # chunk s reached us via s forward hops; send its
                # cotangent one hop back per remaining iteration
                carry_k = jax.lax.ppermute(carry_k, axis_name, bwd_ring)
                carry_v = jax.lax.ppermute(carry_v, axis_name, bwd_ring)
        return dq, carry_k, carry_v

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, joint_bwd(grad)]
        return cache[1]

    requires_grad = (ts_q.requires_grad or ts_k.requires_grad
                     or ts_v.requires_grad)
    dependency = []
    if ts_q.requires_grad:
        dependency.append((ts_q, lambda g: memo(g)[0]))
    if ts_k.requires_grad:
        dependency.append((ts_k, lambda g: memo(g)[1]))
    if ts_v.requires_grad:
        dependency.append((ts_v, lambda g: memo(g)[2]))
    return ts_q.__class__(o, requires_grad, dependency)
