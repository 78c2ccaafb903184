"""Recurrent sequence primitives: LSTM / GRU as single-scan tape edges.

The reference framework has no recurrent machinery at all (its only model
family is the MLP; reference core/ops.py tops out at 2-D matmul,
core/ops.py:150), so this module is an addition in the same
spirit as ``dense_stack_``: the whole time recurrence is ONE primitive —
forward is a single ``lax.scan`` over the time axis and the backward is
the hand-written mirrored REVERSE scan (truncated-nowhere BPTT). No
``jax.grad`` anywhere; these are tape edges like every other primitive
(ops/primitives.py).

Both directions use the cuDNN-style restructuring: everything that does
not depend on the recurrence is hoisted OUT of the scan into big batched
matmuls — forward computes the input projection for all steps as one
[T*B, D] x [D, G*H] matmul, backward emits the per-step gate cotangents
from the scan and computes dWx/dWh/dX/db as three [T*B, .] matmuls after
it. The serial chain is then exactly one [B, H] x [H, G*H] matmul per
step each way (the recurrence's true dependency), each its own kernel
launch inside the scan.

Why one primitive instead of a Python loop of Dense ops: a T-step
recurrence as per-step tape nodes costs O(T) trace size, O(T) XLA
kernels, and a Python-depth backward walk; as a scan pair it is two
compiled kernels regardless of T, with the per-step activations stacked
by the scan itself (the standard JAX recipe — compiler-friendly control
flow, static shapes).

Layout conventions:
- inputs  x  : [B, T, D]   (batch-major at the API; transposed to the
                            scan's [T, B, D] internally)
- weights wx : [D, G*H], wh: [H, G*H], bias b: [1, G*H] where G is the
  gate count (LSTM 4: i, f, g, o — input, forget, cell, output;
  GRU 3: z, r, n — update, reset, candidate). Keeping the gates fused in
  one trailing axis means each scan step is two large matmuls instead of
  2*G small ones.
- outputs    : the full hidden sequence [B, T, H]; callers wanting only
  the last step slice it (the getitem_ scatter VJP routes the cotangent
  correctly).
"""

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.ops import kernels


def _sigmoid(x):
    return jax.nn.sigmoid(x)


def _split4(z):
    h = z.shape[-1] // 4
    return z[..., :h], z[..., h:2 * h], z[..., 2 * h:3 * h], z[..., 3 * h:]


def _split3(z):
    h = z.shape[-1] // 3
    return z[..., :h], z[..., h:2 * h], z[..., 2 * h:]


def lstm_scan_(ts_x, ts_wx, ts_wh, ts_b, h0=None, c0=None, reverse=False):
    """LSTM over [B, T, D] -> hidden sequence [B, T, H] as one tape edge.

    Cell (gate order i, f, g, o; f32 math):

        z = x_t @ wx + h @ wh + b          # one fused [.,4H] pair
        i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
        c = f * c_prev + i * g
        h = o * tanh(c)

    ``h0``/``c0`` are optional Tensors [B, H] (zeros when omitted); if
    they require grad, d h0 / d c0 flow out of the reverse scan's final
    carry. Weight/bias/input cotangents come from the same reverse scan,
    accumulated in-carry — the classic BPTT recurrence, executed as one
    on-device kernel.

    ``reverse=True`` runs the recurrence backwards in time (h_t depends
    on x_t and h_{t+1}); outputs stay aligned to their input positions
    (out[:, t] is the state after consuming x[:, t:] right-to-left) —
    the backward-direction half of a bidirectional RNN. The BPTT scan
    then simply runs in the opposite (forward) direction; the math is
    direction-symmetric.
    """
    x, wx, wh, b = ts_x.data, ts_wx.data, ts_wh.data, ts_b.data
    B, T = x.shape[0], x.shape[1]
    D = x.shape[2]
    H = wh.shape[0]
    h0a = jnp.zeros((B, H), x.dtype) if h0 is None else h0.data
    c0a = jnp.zeros((B, H), x.dtype) if c0 is None else c0.data
    xt = jnp.swapaxes(x, 0, 1)  # [T, B, D]

    # hoist the input projection out of the scan: ONE [T*B, D] x [D, 4H]
    # matmul for all steps (the cuDNN-style restructuring) — only the
    # [B, H] x [H, 4H] hidden matmul remains on the serial chain, halving
    # the dependent-matmul count per step
    xp = (kernels.matmul(xt.reshape(T * B, D), wx) + b).reshape(T, B, 4 * H)

    # the scan saves the minimal activation set — hs, cs, and the packed
    # gates [T, B, 4H]; h/c entering step t are one-step time shifts of
    # the emitted stacks, derived (not stored) in the backward
    def fwd_body(carry, xp_t):
        h_prev, c_prev = carry
        z = xp_t + kernels.matmul(h_prev, wh)
        zi, zf, zg, zo = _split4(z)
        i = _sigmoid(zi)
        f = _sigmoid(zf)
        g = jnp.tanh(zg)
        o = _sigmoid(zo)
        c = f * c_prev + i * g
        h = o * jnp.tanh(c)
        return (h, c), (h, c, jnp.concatenate([i, f, g, o], axis=-1))

    (_, _), (hs, cs, gates) = jax.lax.scan(
        fwd_body, (h0a, c0a), xp, reverse=reverse)
    out = jnp.swapaxes(hs, 0, 1)       # [B, T, H]

    def joint_bwd(grad):
        gt = jnp.swapaxes(jnp.asarray(grad, x.dtype), 0, 1)  # [T, B, H]
        if reverse:
            cprev = jnp.concatenate([cs[1:], c0a[None]], axis=0)
            hprev = jnp.concatenate([hs[1:], h0a[None]], axis=0)
        else:
            cprev = jnp.concatenate([c0a[None], cs[:-1]], axis=0)
            hprev = jnp.concatenate([h0a[None], hs[:-1]], axis=0)
        zeros_bh = jnp.zeros((B, H), x.dtype)

        # the scan carries only (dh, dc) and emits dz per step — ONE
        # serial matmul (dz @ wh.T) on the chain; the weight/input/bias
        # cotangents are three big batched matmuls AFTER it
        def bwd_body(carry, step):
            dh_next, dc_next = carry
            g_t, c_, cp, g4 = step
            i, f = g4[..., :H], g4[..., H:2 * H]
            g_, o = g4[..., 2 * H:3 * H], g4[..., 3 * H:]
            tc = jnp.tanh(c_)
            dh = g_t + dh_next
            do = dh * tc
            dc = dh * o * (1.0 - tc * tc) + dc_next
            di = dc * g_
            dg = dc * i
            df = dc * cp
            dz = jnp.concatenate(
                [di * i * (1.0 - i),
                 df * f * (1.0 - f),
                 dg * (1.0 - g_ * g_),
                 do * o * (1.0 - o)], axis=-1)
            return (kernels.matmul(dz, wh.T), dc * f), dz

        (dh0, dc0), dzs = jax.lax.scan(
            bwd_body, (zeros_bh, zeros_bh), (gt, cs, cprev, gates),
            reverse=not reverse)
        dz_flat = dzs.reshape(T * B, 4 * H)
        dxs = kernels.matmul(dz_flat, wx.T).reshape(T, B, D)
        dwx = kernels.matmul(xt.reshape(T * B, D).T, dz_flat)
        dwh = kernels.matmul(hprev.reshape(T * B, H).T, dz_flat)
        db = dz_flat.sum(axis=0, keepdims=True)
        return jnp.swapaxes(dxs, 0, 1), dwx, dwh, db, dh0, dc0

    return _build_recurrent_node(
        ts_x, ts_wx, ts_wh, ts_b, h0, c0, out, joint_bwd)


def gru_scan_(ts_x, ts_wx, ts_wh, ts_b, h0=None, reverse=False):
    """GRU over [B, T, D] -> hidden sequence [B, T, H] as one tape edge.

    Cell (gate order z, r, n; the single-bias formulation — the reset
    gate multiplies the hidden CONTRIBUTION ``h @ wh_n``, matching the
    classic Cho et al. form):

        a = x_t @ wx + b;   u = h @ wh          # fused [., 3H] pairs
        z = sigmoid(a_z + u_z)
        r = sigmoid(a_r + u_r)
        n = tanh(a_n + r * u_n)
        h' = (1 - z) * n + z * h

    ``reverse=True``: backward-in-time recurrence, outputs aligned to
    input positions (see lstm_scan_).
    """
    x, wx, wh, b = ts_x.data, ts_wx.data, ts_wh.data, ts_b.data
    B, T = x.shape[0], x.shape[1]
    D = x.shape[2]
    H = wh.shape[0]
    h0a = jnp.zeros((B, H), x.dtype) if h0 is None else h0.data
    xt = jnp.swapaxes(x, 0, 1)

    # hoisted input projection (see lstm_scan_): all T input matmuls as
    # ONE [T*B, D] x [D, 3H] matmul; only h @ wh stays on the serial chain
    ap = (kernels.matmul(xt.reshape(T * B, D), wx) + b).reshape(T, B, 3 * H)

    # the scan saves the minimal set — hs, packed (z, r, n) gates, and un
    # (the reset-gated hidden contribution); h entering step t is a
    # one-step time shift of hs, derived (not stored) in the backward
    def fwd_body(h_prev, a_t):
        u = kernels.matmul(h_prev, wh)
        az, ar, an = _split3(a_t)
        uz, ur, un = _split3(u)
        z = _sigmoid(az + uz)
        r = _sigmoid(ar + ur)
        n = jnp.tanh(an + r * un)
        h = (1.0 - z) * n + z * h_prev
        return h, (h, jnp.concatenate([z, r, n], axis=-1), un)

    _, (hs, gates, un_s) = jax.lax.scan(fwd_body, h0a, ap, reverse=reverse)
    out = jnp.swapaxes(hs, 0, 1)

    def joint_bwd(grad):
        gt = jnp.swapaxes(jnp.asarray(grad, x.dtype), 0, 1)
        if reverse:
            hprev = jnp.concatenate([hs[1:], h0a[None]], axis=0)
        else:
            hprev = jnp.concatenate([h0a[None], hs[:-1]], axis=0)
        zeros_bh = jnp.zeros((B, H), x.dtype)

        # scan emits (da, du) per step; dwx/dwh/dx/db are batched post-scan
        # matmuls — one serial matmul (du @ wh.T) on the chain
        def bwd_body(dh_next, step):
            g_t, hp, g3, un = step
            z, r = g3[..., :H], g3[..., H:2 * H]
            n = g3[..., 2 * H:]
            dh = g_t + dh_next
            dz_gate = dh * (hp - n)
            dn_pre = dh * (1.0 - z) * (1.0 - n * n)
            dr = dn_pre * un
            dun = dn_pre * r
            daz = dz_gate * z * (1.0 - z)
            dar = dr * r * (1.0 - r)
            da = jnp.concatenate([daz, dar, dn_pre], axis=-1)
            du = jnp.concatenate([daz, dar, dun], axis=-1)
            dh_prev = dh * z + kernels.matmul(du, wh.T)
            return dh_prev, (da, du)

        dh0, (das, dus) = jax.lax.scan(
            bwd_body, zeros_bh, (gt, hprev, gates, un_s),
            reverse=not reverse)
        da_flat = das.reshape(T * B, 3 * H)
        du_flat = dus.reshape(T * B, 3 * H)
        dxs = kernels.matmul(da_flat, wx.T).reshape(T, B, D)
        dwx = kernels.matmul(xt.reshape(T * B, D).T, da_flat)
        dwh = kernels.matmul(hprev.reshape(T * B, H).T, du_flat)
        db = da_flat.sum(axis=0, keepdims=True)
        return jnp.swapaxes(dxs, 0, 1), dwx, dwh, db, dh0, None

    return _build_recurrent_node(
        ts_x, ts_wx, ts_wh, ts_b, h0, None, out, joint_bwd)


def _build_recurrent_node(ts_x, ts_wx, ts_wh, ts_b, h0, c0, out, joint_bwd):
    """Shared tape-node assembly: memoized joint backward (one reverse
    scan per backward pass regardless of how many inputs require grad,
    same strong-ref identity cache as dense_stack_), one dependency per
    differentiable input."""
    cache = []  # [grad_object, (dx, dwx, dwh, db, dh0, dc0)]

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, joint_bwd(grad)]
        return cache[1]

    parents = [(ts_x, 0), (ts_wx, 1), (ts_wh, 2), (ts_b, 3)]
    if h0 is not None:
        parents.append((h0, 4))
    if c0 is not None:
        parents.append((c0, 5))

    dependency = []
    requires_grad = False
    for ts, slot in parents:
        if ts is not None and ts.requires_grad:
            requires_grad = True
            dependency.append(
                (ts, (lambda s: lambda g: memo(g)[s])(slot)))
    return ts_x.__class__(out, requires_grad, dependency)
