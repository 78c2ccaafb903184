"""Context parallelism: RING ATTENTION over a mesh axis.

Shards the SEQUENCE across devices (params replicated): each device holds
its queries and its K/V chunk for the local T/n rows, and the K/V chunks
rotate around the ring via ``ppermute`` — n-1 hops per attention, the
classic ring-attention communication topology.

The default mode ("ring") is BLOCKWISE ring attention
(ops/ring_attention.py): each arriving K/V chunk is consumed by the
flash-attention kernels and only running per-hop (o_s, lse_s) pairs are
combined with logsumexp algebra — NO [T/n, T] score block ever
materializes (memory O(T/n · d) per device plus one kernel tile), and the
hand-written backward re-walks the ring with the flash recompute scheme,
routing dK/dV cotangents back over a reverse ppermute ring. Numerics are
exactly the one global softmax. "ring_exact" keeps the original
concatenated-scores formulation ([T/n, T] per device, one softmax_ over
ring-ordered columns) as the cross-check/control path.

Parameters are replicated; their per-device gradients are partial
(computed from 1/n of the sequence rows) and get ONE psum before the
optimizer — the same pattern as data parallelism, but sharding the
sequence instead of the batch.

Causal masking is supported in all modes: blockwise ring handles the
diagonal chunk with the kernels' static causal path and off-diagonal
chunks with a visibility predicate; ring_exact masks each score block by
GLOBAL positions (the resident K chunk at ring step s belongs to device
(idx-s) mod n); Ulysses applies the ordinary full-length mask (its
all_to_all output is in global order). Embedding/positional/head layers
run replicated outside the ring region.

Dropout IS supported (round 5; previously rejected): per-step rng is
folded with the step counter and — for sequence-sharded sites — the
device's axis index, exactly like DataParallel's per-device mask
decorrelation (parallel/data_parallel.py). Replicated sites (layers
outside the block chain) use the UN-folded key so every device applies
the identical mask and the replication invariant holds. The blockwise
ring's attention-probability dropout rides the flash kernels' in-kernel
hash masks with per-hop seeds.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.nn.layers import (
    LlamaBlock, TransformerBlock, _repeat_heads,
)
from tinynn_autograd_tpu.parallel._common import (
    adopt_pending_opt, bind_traced_layer, rebind_concrete, shard_opt_state,
    wrapper_load, wrapper_save,
)
from tinynn_autograd_tpu.parallel.mesh import make_mesh


class ContextParallel:
    """Usage::

        cp = ContextParallel(model, mesh=make_mesh(8, axis_name="ctx"))
        loss = cp.train_step(x, y)     # full batch, replicated
    """

    def __init__(self, model, mesh=None, n_devices=None, axis_name="ctx",
                 mode="ring"):
        """``mode``: "ring" (default) is BLOCKWISE ring attention — K/V
        chunks rotate over ppermute (n-1 hops) and are consumed by the
        flash kernels with running logsumexp combine (no [T/n, T] scores);
        "ring_exact" keeps the concatenated-scores control path (T^2/n
        score memory per device); "ulysses" re-shards seq<->heads with two
        all_to_all pairs so attention runs on H/n full-sequence heads per
        device (head count must divide by the mesh)."""
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, axis_name)
        self.axis_name = axis_name
        self.n_devices = int(self.mesh.devices.size)
        if mode not in ("ring", "ring_exact", "ulysses"):
            raise ValueError(
                "mode must be 'ring', 'ring_exact' or 'ulysses', got %r"
                % (mode,))
        self.mode = mode
        self._params = None
        self._opt_state = None
        self._step_fn = None
        self._base_key = None

    @property
    def net(self):
        return self.model.net

    def _validate(self):
        for layer in self.net.layers:
            if (self.mode == "ulysses"
                    and isinstance(layer, (TransformerBlock, LlamaBlock))
                    and layer.num_heads % self.n_devices):
                raise ValueError(
                    "ulysses needs heads (%d) divisible by the mesh (%d)"
                    % (layer.num_heads, self.n_devices))
            if (self.mode == "ulysses" and isinstance(layer, LlamaBlock)
                    and layer.num_kv_heads % self.n_devices):
                raise ValueError(
                    "ulysses GQA needs kv heads (%d) divisible by the "
                    "mesh (%d)" % (layer.num_kv_heads, self.n_devices))
            # sliding-window blocks under the ring modes take the ONE-HOP
            # neighbor-exchange path (window <= T/n, checked at forward
            # time when the chunk length is known); ulysses masks the
            # globally-ordered rows via layer._mask — both supported

    # ------------------------------------------------------------- forward

    def _block_drop_keys(self, layer, loc_rng, li):
        """Per-block mask keys (attn-prob seed, residual, MLP) from the
        DEVICE-folded rng — all the block's dropout sites act on
        sequence-sharded activations, so masks must differ per device
        (decorrelation, like DataParallel's per-shard masks)."""
        drop = (layer.is_training and loc_rng is not None
                and (layer.dropout > 0.0 or layer.attn_dropout > 0.0))
        if not drop:
            return None
        return jax.random.split(jax.random.fold_in(loc_rng, li), 3)

    def _residual_mlp(self, layer, p, h, ctx_flat, keys):
        """Shared tail: ctx projection (+ residual dropout), residual add,
        MLP (+ dropout) — identical for every attention mode. Family-
        aware: LlamaBlocks take the RMSNorm + SwiGLU (bias-free) tail."""
        attn_out = ctx_flat @ p["wo"]
        if keys is not None and layer.dropout > 0.0:
            attn_out = ops.dropout_(attn_out, layer.dropout, keys[1])
        x2 = h + attn_out
        if isinstance(layer, LlamaBlock):
            yn = ops.rms_norm_(x2, p["g2"], eps=layer.eps)
            y = (ops.silu_(yn @ p["w1"]) * (yn @ p["w3"])) @ p["w2"]
        else:
            yn = ops.layer_norm_(x2, p["g2"], p["be2"], eps=layer.eps)
            y = ops.gelu_(yn @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        if keys is not None and layer.dropout > 0.0:
            y = ops.dropout_(y, layer.dropout, keys[2])
        return x2 + y

    def _block_qkv(self, layer, p, h):
        """Family-aware projections on the local sequence chunk
        [B, Tl, D] -> (q [B, H, Tl, hd], k, v) with k/v at the layer's KV
        head count. LlamaBlocks: RMSNorm + RoPE at GLOBAL positions
        (idx * Tl + local row) — each row is rotated by its absolute
        position BEFORE the chunks circulate, so the rotations ride along
        with the K chunks and any consumer sees correctly-phased keys."""
        b, tl, _ = h.shape
        hd = layer.head_dim

        def split_heads(x, heads):
            return x.reshape((b, tl, heads, hd)).transpose((0, 2, 1, 3))

        if isinstance(layer, LlamaBlock):
            pos = (jax.lax.axis_index(self.axis_name) * tl
                   + jnp.arange(tl, dtype=jnp.int32))
            xn = ops.rms_norm_(h, p["g1"], eps=layer.eps)
            q = ops.rope_(split_heads(xn @ p["wq"], layer.num_heads),
                          base=layer.rope_base, positions=pos)
            k = ops.rope_(split_heads(xn @ p["wk"], layer.num_kv_heads),
                          base=layer.rope_base, positions=pos)
            v = split_heads(xn @ p["wv"], layer.num_kv_heads)
            return q, k, v
        xn = ops.layer_norm_(h, p["g1"], p["be1"], eps=layer.eps)
        q = split_heads(xn @ p["wq"], layer.num_heads)
        k = split_heads(xn @ p["wk"], layer.num_heads)
        v = split_heads(xn @ p["wv"], layer.num_heads)
        return q, k, v

    def _windowed_one_hop_ctx(self, layer, q, kj, vj, tl, hd, window,
                              keys):
        """Sliding-window attention on the sequence shard with ONE
        neighbor hop: fetch the PREVIOUS device's K/V chunk (ppermute),
        concat, and mask by GLOBAL positions to the causal band
        (p - window, p]. Device 0's 'previous' chunk arrives from device
        n-1 via the ring wrap, but its global positions exceed every
        local row, so the causal mask kills it — no special case. Exact:
        window <= Tl guarantees the band never reaches further back.
        O(Tl * 2Tl) scores instead of the full ring's Tl * T."""
        axis = self.axis_name
        n = self.n_devices
        if kj.shape[1] != q.shape[1]:   # GQA: scores materialize here
            group = q.shape[1] // kj.shape[1]
            kj = _repeat_heads(kj, group)
            vj = _repeat_heads(vj, group)
        one_hop = [(i, (i + 1) % n) for i in range(n)]
        k_prev = ops.ppermute_(kj, axis, one_hop)
        v_prev = ops.ppermute_(vj, axis, one_hop)
        k_all = ops.concat([k_prev, kj], axis=2)      # [B, H, 2Tl, hd]
        v_all = ops.concat([v_prev, vj], axis=2)
        idx = jax.lax.axis_index(axis)
        rows = idx * tl + jax.lax.broadcasted_iota(
            jnp.int32, (tl, 2 * tl), 0)
        col_iota = jax.lax.broadcasted_iota(jnp.int32, (tl, 2 * tl), 1)
        owner = jnp.where(col_iota < tl, (idx - 1) % n, idx)
        cols = owner * tl + jnp.where(col_iota < tl, col_iota,
                                      col_iota - tl)
        vis = (cols <= rows) & (rows - cols < window)
        mask = jnp.where(vis, 0.0, -1e9)
        scores = (q @ k_all.transpose((0, 1, 3, 2))) \
            * (1.0 / np.sqrt(hd)) + mask
        attn = ops.softmax_(scores, axis=-1)
        if keys is not None and layer.attn_dropout > 0.0:
            attn = ops.dropout_(attn, layer.attn_dropout, keys[0])
        return attn @ v_all

    def _ring_block_forward(self, layer, params, h, loc_rng=None, li=0):
        """One TransformerBlock OR LlamaBlock on the sequence shard
        [B, T/n, D] with K/V rotating around the ring; replicated params
        as traced leaves.

        mode="ring": BLOCKWISE — the whole ring is the one
        ops.ring_flash_attention_ tape primitive (flash kernels per hop,
        running logsumexp combine; no [T/n, T] scores anywhere). GQA
        LlamaBlocks keep K/V at Hkv heads END-TO-END here: each hop's
        mha_fwd loops the query groups against the shared chunk and the
        reverse ring carries the UNREPEATED dK/dV — group-x less ring
        traffic than a repeated-KV formulation.
        mode="ring_exact": the original concatenated-scores control path
        (GQA repeats K/V at the tape level first).
        """
        axis = self.axis_name
        n = self.n_devices
        p = {k: Tensor(v, requires_grad=True) for k, v in params.items()}
        b, tl, d = h.shape
        hd = layer.head_dim
        keys = self._block_drop_keys(layer, loc_rng, li)

        q, kj, vj = self._block_qkv(layer, p, h)

        window = getattr(layer, "attn_window", None)
        if window is not None:
            # SLIDING WINDOW: when the band fits one chunk, a query needs
            # keys only from its own chunk and its predecessor — ONE
            # neighbor ppermute replaces the n-1-hop ring entirely (local
            # attention parallelizes trivially over the sequence)
            if window > tl:
                raise ValueError(
                    "ring CP with sliding-window attention needs "
                    "window (%d) <= the local chunk T/n (%d) — one "
                    "neighbor hop covers the band; for wider windows "
                    "use mode='ulysses'" % (window, tl))
            ctx = self._windowed_one_hop_ctx(layer, q, kj, vj, tl,
                                             hd, window, keys)
        elif self.mode == "ring":
            attn_rate = (layer.attn_dropout
                         if keys is not None and layer.attn_dropout > 0.0
                         else 0.0)
            seed = (jax.random.bits(keys[0], dtype=jnp.uint32)
                    if attn_rate else None)
            ctx = ops.ring_flash_attention_(
                q, kj, vj, axis, n, causal=layer.causal,
                scale=1.0 / np.sqrt(hd),
                dropout_rate=attn_rate, dropout_seed=seed)
        else:  # ring_exact: concat scores, one softmax (control path)
            if kj.shape[1] != q.shape[1]:   # GQA: materialize per-chunk
                group = q.shape[1] // kj.shape[1]
                kj = _repeat_heads(kj, group)
                vj = _repeat_heads(vj, group)
            ring = [(i, (i + 1) % n) for i in range(n)]
            # Softmax is column-order invariant, so ring-arrival order is
            # fine as long as V blocks align with their score blocks.
            idx = jax.lax.axis_index(axis)
            row_pos = idx * tl + jax.lax.broadcasted_iota(
                jnp.int32, (tl, tl), 0)
            col_iota = jax.lax.broadcasted_iota(jnp.int32, (tl, tl), 1)
            score_blocks = []
            v_blocks = []
            for s in range(n):
                block = q @ kj.transpose((0, 1, 3, 2))
                if layer.causal:
                    # the resident K chunk at ring step s belongs to device
                    # (idx - s) mod n: mask by GLOBAL positions
                    owner = (idx - s) % n
                    col_pos = owner * tl + col_iota
                    block = block + jnp.where(col_pos <= row_pos, 0.0, -1e9)
                score_blocks.append(block)
                v_blocks.append(vj)
                if s < n - 1:
                    kj = ops.ppermute_(kj, axis, ring)
                    vj = ops.ppermute_(vj, axis, ring)
            scores = ops.concat(score_blocks, axis=-1) * (1.0 / np.sqrt(hd))
            attn = ops.softmax_(scores, axis=-1)   # [B,H,Tl,n*Tl]
            if keys is not None and layer.attn_dropout > 0.0:
                attn = ops.dropout_(attn, layer.attn_dropout, keys[0])
            ctx = None
            for s in range(n):
                piece = attn[:, :, :, s * tl:(s + 1) * tl] @ v_blocks[s]
                ctx = piece if ctx is None else ctx + piece
        ctx = ctx.transpose((0, 2, 1, 3)).reshape((b, tl, d))
        return self._residual_mlp(layer, p, h, ctx, keys), p

    def _ulysses_block_forward(self, layer, params, h, loc_rng=None, li=0):
        """Ulysses attention on the sequence shard [B, T/n, D]: two
        all_to_all pairs re-shard q/k/v from sequence- to HEAD-sharding
        (each device attends over the FULL sequence for its H/n heads) and
        the context back. Replicated params as traced leaves; their
        (seq/head-local, hence partial) grads are psum'd by local_step.
        Dropout: attention probabilities are HEAD-sharded and residual
        sites sequence-sharded — both use device-folded keys."""
        axis = self.axis_name
        n = self.n_devices
        p = {k: Tensor(v, requires_grad=True) for k, v in params.items()}
        b, tl, d = h.shape
        hd = layer.head_dim
        keys = self._block_drop_keys(layer, loc_rng, li)

        def to_head_sharded(x):  # [B,H,Tl,hd] -> [B,H/n,T,hd]
            return ops.all_to_all_(x, axis, split_axis=1, concat_axis=2)

        # family-aware projections; llama's RoPE is applied BEFORE the
        # a2a (local rows at their global positions), so the re-shard
        # moves already-phased heads
        q, k, v = self._block_qkv(layer, p, h)
        q, k, v = to_head_sharded(q), to_head_sharded(k), to_head_sharded(v)
        if k.shape[1] != q.shape[1]:
            # GQA: the contiguous-chunk a2a keeps each query head's kv
            # head on the same device (heads [dev*H/n..) pair with kv
            # heads [dev*Hkv/n..)); repeat locally for the score matmuls
            group = q.shape[1] // k.shape[1]
            k = _repeat_heads(k, group)
            v = _repeat_heads(v, group)
        scores = (q @ k.transpose((0, 1, 3, 2))) * (1.0 / np.sqrt(hd))
        # after the a2a the sequence axis is in GLOBAL order, so the
        # ordinary full-length causal mask applies directly
        mask = layer._mask(tl * n)
        if mask is not None:
            scores = scores + mask
        attn = ops.softmax_(scores, axis=-1)
        if keys is not None and layer.attn_dropout > 0.0:
            attn = ops.dropout_(attn, layer.attn_dropout, keys[0])
        ctx = attn @ v                                   # [B,H/n,T,hd]
        ctx = ops.all_to_all_(ctx, axis, split_axis=2, concat_axis=1)
        ctx = ctx.transpose((0, 2, 1, 3)).reshape((b, tl, d))
        return self._residual_mlp(layer, p, h, ctx, keys), p

    def _forward(self, params, x, rep_rng=None, loc_rng=None):
        """``rep_rng``: step-folded key, IDENTICAL on every device — used
        for stochastic layers running replicated (outside the block chain)
        so the replication invariant holds. ``loc_rng``: additionally
        axis-folded — used for the blocks' sequence-sharded mask sites."""
        axis = self.axis_name
        h = Tensor(x)
        tensors = []
        seq_sharded = False
        for li, layer in enumerate(self.net.layers):
            if isinstance(layer, (TransformerBlock, LlamaBlock)):
                if not seq_sharded:
                    if h.shape[1] % self.n_devices:
                        raise ValueError(
                            "sequence length %d doesn't divide over %d "
                            "devices" % (h.shape[1], self.n_devices))
                    h = ops.split_axis_(h, axis, self.n_devices, axis=1)
                    seq_sharded = True
                if self.mode == "ulysses":
                    h, p = self._ulysses_block_forward(
                        layer, params[li], h, loc_rng, li)
                else:
                    h, p = self._ring_block_forward(
                        layer, params[li], h, loc_rng, li)
                tensors.append(p)
                continue
            if seq_sharded:
                h = ops.gather_axis_(h, axis, self.n_devices, axis=1)
                seq_sharded = False
            if hasattr(layer, "set_rng") and rep_rng is not None:
                # replicated site: SAME key on all devices
                layer.set_rng(jax.random.fold_in(rep_rng, li))
            if params[li]:
                tensors.append(bind_traced_layer(layer, params[li]))
                h = layer.forward(h)
            else:
                h = layer.forward(h)
                tensors.append({})
        if seq_sharded:
            h = ops.gather_axis_(h, axis, self.n_devices, axis=1)
        return h, tensors

    # --------------------------------------------------------------- build

    def _build(self):
        loss_fn = self.model.loss
        optimizer = self.model.optimizer
        axis = self.axis_name
        block_idx = {li for li, l in enumerate(self.net.layers)
                     if isinstance(l, (TransformerBlock, LlamaBlock))}
        stochastic = any(hasattr(l, "set_rng") for l in self.net.layers)
        base_key = self._base_key

        def local_step(params, opt_state, x, y):
            rep_rng = loc_rng = None
            if stochastic:
                # step-folded key shared by all devices (replicated mask
                # sites) + axis-folded key for sequence-sharded sites —
                # the DataParallel decorrelation pattern
                rep_rng = jax.random.fold_in(base_key, opt_state["t"])
                loc_rng = jax.random.fold_in(
                    rep_rng, jax.lax.axis_index(axis))
            pred, tensors = self._forward(params, x, rep_rng, loc_rng)
            loss_t = loss_fn.loss(pred, Tensor(y))
            loss_t.backward()
            grads = [
                {k: t.grad for k, t in layer.items()} for layer in tensors
            ]
            # ring-region params are replicated but each device only saw
            # its sequence rows: one all-reduce makes the grads total AND
            # identical, keeping the replicated updates in sync
            for li in block_idx:
                grads[li] = {k: jax.lax.psum(g, axis)
                             for k, g in grads[li].items()}
            steps, new_opt = optimizer.update(grads, params, opt_state)
            new_params = jax.tree.map(lambda pp, s: pp + s, params, steps)
            return new_params, new_opt, loss_t.data

        rep = [{k: P() for k in layer} for layer in self._params]
        opt_spec = {"t": P(),
                    "slots": {n: rep for n in optimizer.slot_names}}
        sharded = jax.shard_map(
            local_step, mesh=self.mesh,
            in_specs=(rep, opt_spec, P(), P()),
            out_specs=(rep, opt_spec, P()),
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0, 1))

    # ----------------------------------------------------------- train API

    def train_step(self, x, y):
        """One ring-attention fused step on a replicated batch; returns the
        loss (device scalar)."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        if not self.net.is_init:
            self.net.init(x.shape)
        self._validate()
        if self._params is None:
            rep = NamedSharding(self.mesh, P())
            self._params = [
                {k: jax.device_put(v.data, rep)
                 for k, v in layer.params.items() if v is not None}
                for layer in self.net.layers
            ]
            self._specs = [{k: P() for k in layer} for layer in self._params]
        if self._opt_state is None:
            self._opt_state = adopt_pending_opt(
                self, lambda host: shard_opt_state(
                    self.mesh, self._specs, host))
        if self._step_fn is None:
            self.model.set_phase("TRAIN")
            if self._base_key is None:
                from tinynn_autograd_tpu.utils import seeder

                self._base_key = seeder.next_key()
            self._step_fn = self._build()

        rep = NamedSharding(self.mesh, P())
        x = jax.device_put(x, rep)
        y = jax.device_put(y, rep)
        self._params, self._opt_state, loss = self._step_fn(
            self._params, self._opt_state, x, y)
        rebind_concrete(self.net, self._params)
        return loss

    def gather_params(self):
        return [jax.tree.map(np.asarray, layer) for layer in self._params]

    # ----------------------------------------------------------- checkpoint

    def save(self, path):
        """Checkpoint in the plain Model format — loadable by
        ContextParallel OR a single-device Model."""
        wrapper_save(self, path)

    def load(self, path):
        """Restore a Model-format checkpoint; the optimizer state
        re-replicates over the mesh at the next train_step."""
        wrapper_load(self, path)
