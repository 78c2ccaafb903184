"""Tensor parallelism: Megatron-style sharded MLP training over a mesh.

Beyond data parallelism (data_parallel.py), this shards the MODEL: Dense
layers are split across the mesh in column/row pairs —

- column-parallel layer: W [D, H] split on the OUTPUT dim -> each device
  holds W[:, shard] and computes its slice of the activations (no
  communication; the following elementwise activation applies per-shard);
- row-parallel layer: W [H, D'] split on the INPUT dim -> each device
  contracts its activation shard and a ``psum`` reassembles the
  output.

One all-reduce per layer PAIR in forward, and (by symmetry of the VJPs) one
in backward — the standard Megatron-LM communication pattern, expressed with
``shard_map`` + ``jax.lax.psum`` (never NCCL-style point-to-point).

The same tape autodiff runs unchanged inside the shard_map region: psum's
adjoint under shard_map is identity-per-shard, so the hand VJPs of matmul
compose with the collective exactly like the forward. Gradients of sharded
weights stay sharded (each device updates its own shard); gradients of
replicated params (biases of row layers, all batch-path tensors) are
psum-reduced where the forward broadcast them.

Scope: Dense/Activation stacks (paired col/row from the front, odd
trailing Dense replicated) AND TransformerBlocks — Megatron attention:
wq/wk/wv column-sharded by head group (attention itself is embarrassingly
parallel over local heads), wo row-sharded; MLP w1 column / w2 row. One
psum per attention, one per MLP; the replicated-input fan-outs carry the
"f" conjugate (ops.replicate_grad_) so backward reassembles full input
cotangents. Embedding/positional/other replicated-param layers train as
traced replicated leaves.

``sequence_parallel=True`` switches the block chain to Megatron-SP:
activations between blocks live sequence-sharded [B, T/n, D], entered via
``split_axis_`` (VJP: all-gather) and exited via ``gather_axis_`` (VJP:
slice); inside each block the fan-out becomes ``all_gather_`` over the
sequence (VJP: reduce-scatter) and the fan-in ``psum_scatter_`` (VJP:
all-gather) — the g/g-bar conjugates. Same bytes on the wire as the psum
pair, 1/n the norm/residual compute and activation memory; grads of the
seq-local replicated params (norm scales, output bias) get one psum.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.nn.layers import Dense, LlamaBlock, TransformerBlock
from tinynn_autograd_tpu.parallel._common import (
    adopt_pending_opt, bind_traced_layer, rebind_concrete, shard_opt_state,
    wrapper_load, wrapper_save,
)
from tinynn_autograd_tpu.parallel.mesh import make_mesh


class TensorParallel:
    """Shard a Dense/Activation Net across a 1-D mesh and train with the
    fused step (forward + tape backward + optimizer) inside shard_map.

    Usage::

        tp = TensorParallel(model, mesh=make_mesh(8))
        loss = tp.train_step(x, y)     # full batch, replicated
    """

    def __init__(self, model, mesh=None, n_devices=None, axis_name="model",
                 data_axis=None, sequence_parallel=False):
        """``data_axis``: name of a SECOND mesh axis to data-parallelize
        over (2-D hybrid DP x TP): the batch is sharded along it and
        gradients are pmean-reduced across it before the optimizer.

        ``sequence_parallel``: Megatron-SP for TransformerBlock chains —
        activations between blocks are SEQUENCE-sharded [B, T/n, D]
        (norms/residuals run on 1/n of the rows), and the TP fan-in/out
        psums become all-gather (entering attention/MLP) and
        reduce-scatter (leaving) — same total bytes on the wire, 1/n the
        normalization/residual compute and activation memory. Sequence
        length must divide by the mesh."""
        self.model = model
        self.sequence_parallel = sequence_parallel
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, axis_name)
        self.axis_name = axis_name
        self.data_axis = data_axis
        if data_axis is not None and data_axis not in self.mesh.axis_names:
            raise ValueError("data_axis %r not in mesh axes %s"
                             % (data_axis, self.mesh.axis_names))
        self.n_devices = int(dict(zip(self.mesh.axis_names,
                                      self.mesh.devices.shape))[axis_name])
        self._params = None          # sharded param pytree (device view)
        self._opt_state = None
        self._step_fn = None
        self._layout = None          # per-Dense: "col" | "row" | "rep"
        self._base_key = None

    # ----------------------------------------------------------- sharding

    @property
    def net(self):
        return self.model.net

    def _plan_layout(self):
        """Pair Dense layers (col, row, col, row, ...); each pair's inner
        width must divide by the mesh. TransformerBlocks are head-sharded
        (Megatron attention: wq/wk/wv column by head group, wo row; MLP w1
        col / w2 row). Other layers run replicated."""
        denses = [l for l in self.net.layers if isinstance(l, Dense)]
        for layer in self.net.layers:
            if isinstance(layer, (TransformerBlock, LlamaBlock)):
                if layer.num_heads % self.n_devices:
                    raise ValueError(
                        "%d heads don't divide over %d devices"
                        % (layer.num_heads, self.n_devices))
                if layer.shapes["w1"][1] % self.n_devices:
                    raise ValueError(
                        "MLP hidden %d doesn't divide over %d devices"
                        % (layer.shapes["w1"][1], self.n_devices))
            if isinstance(layer, LlamaBlock):
                if layer.num_kv_heads % self.n_devices:
                    raise ValueError(
                        "GQA: %d kv heads don't divide over %d devices "
                        "(MQA/GQA narrower than the mesh would need kv "
                        "replication — shard fewer ways or raise "
                        "num_kv_heads)" % (layer.num_kv_heads,
                                           self.n_devices))
        # pair only CONSECUTIVE Dense runs: a pair spanning a non-Dense,
        # non-Activation layer (e.g. a TransformerBlock or LayerNorm) would
        # feed feature-sharded activations into full-width replicated math
        from tinynn_autograd_tpu.nn.layers import Activation

        runs, current = [], []
        for layer in self.net.layers:
            if isinstance(layer, Dense):
                current.append(layer)
            elif isinstance(layer, Activation):
                continue  # elementwise: transparent to the pairing
            elif current:
                runs.append(current)
                current = []
        if current:
            runs.append(current)

        layout = []
        for run in runs:
            i = 0
            while i < len(run):
                if i + 1 < len(run) and (
                        run[i].shapes["w"][1] % self.n_devices == 0):
                    layout += ["col", "row"]
                    i += 2
                else:
                    layout.append("rep")
                    i += 1
        self._layout = layout
        return denses

    def _shard_spec(self, kind, name):
        if kind == "col":
            # W [D, H/n] per device, b [1, H/n]
            return P(None, self.axis_name)
        if kind == "row" and name == "w":
            return P(self.axis_name, None)   # W [H/n, D']
        return P()                            # row bias + replicated layers

    def _block_spec(self, name):
        """Megatron layout for a TransformerBlock's flat param dict.
        The SAME rule covers LlamaBlock: wq/wk/wv column-sharded by head
        group (wk/wv's columns are kv heads — GQA shards Hkv/n of them
        per device, keeping each query head's kv head local), w1/w3
        (SwiGLU gate+up) column, wo/w2 row, norm gains replicated."""
        if name in ("wq", "wk", "wv", "w1", "w3", "b1"):
            return P(None, self.axis_name)    # column (output) sharded
        if name in ("wo", "w2"):
            return P(self.axis_name, None)    # row (input) sharded
        return P()                            # norms + output biases

    def _shard_params(self):
        """Split the (initialized, replicated) layer params across the mesh
        according to the layout; returns the sharded pytree."""
        self._plan_layout()
        tree = []
        dense_i = 0
        self._specs = []
        for layer in self.net.layers:
            layer_tree = {}
            layer_specs = {}
            if isinstance(layer, Dense):
                kind = self._layout[dense_i]
                for name, ts in layer.params.items():
                    spec = self._shard_spec(kind, name)
                    layer_tree[name] = jax.device_put(
                        ts.data, NamedSharding(self.mesh, spec))
                    layer_specs[name] = spec
                dense_i += 1
            elif isinstance(layer, (TransformerBlock, LlamaBlock)):
                for name, ts in layer.params.items():
                    spec = self._block_spec(name)
                    layer_tree[name] = jax.device_put(
                        ts.data, NamedSharding(self.mesh, spec))
                    layer_specs[name] = spec
            else:
                # any other layer's params run replicated
                for name, ts in layer.params.items():
                    if ts is None:
                        continue
                    layer_tree[name] = jax.device_put(
                        ts.data, NamedSharding(self.mesh, P()))
                    layer_specs[name] = P()
            self._specs.append(layer_specs)
            tree.append(layer_tree)
        return tree

    # ------------------------------------------------------------ forward

    def _tp_forward(self, params, x, rep_rng=None, loc_rng=None):
        """Per-shard forward: runs INSIDE shard_map on local param shards;
        returns the replicated logits Tensor (tape attached).

        Dropout rng discipline (round 5): ``rep_rng`` is identical across
        the MODEL axis (folded with the step counter and, in hybrid mode,
        the data-axis index) — used for mask sites whose activations are
        replicated over the model axis, so every device applies the SAME
        mask and replication holds. ``loc_rng`` additionally folds the
        model-axis index — used for HEAD-sharded (attention-probability)
        and, under Megatron-SP, SEQUENCE-sharded sites, where per-device
        decorrelation is correct (disjoint heads / rows)."""
        axis = self.axis_name
        h = Tensor(x)
        dense_i = 0
        seq_sharded = False   # Megatron-SP region: h is [B, T/n, D]
        tensors = []   # per-layer dict of param Tensors (for grads)
        for li, layer in enumerate(self.net.layers):
            if (seq_sharded
                    and not isinstance(layer,
                                       (TransformerBlock, LlamaBlock))):
                # leaving the block chain: back to the replicated layout
                # (gather_axis_, NOT all_gather_: downstream is replicated,
                # so the VJP must slice, not reduce-scatter)
                h = ops.gather_axis_(h, axis, self.n_devices, axis=1)
                seq_sharded = False
            if isinstance(layer, Dense):
                kind = self._layout[dense_i]
                w = Tensor(params[li]["w"], requires_grad=True)
                b = Tensor(params[li]["b"], requires_grad=True)
                tensors.append({"w": w, "b": b})
                if kind == "row":
                    # input h is output-sharded from the preceding col layer
                    h = ops.psum_(h @ w, axis) + b
                elif kind == "col":
                    # Megatron "f": identity fwd, psum bwd — the input is
                    # replicated but each device's backward only produces
                    # its head/column shard's PARTIAL input cotangent
                    h = ops.replicate_grad_(h, axis) @ w + b
                else:  # rep: replicated weights, replicated activations
                    h = h @ w + b
                dense_i += 1
            elif isinstance(layer, (TransformerBlock, LlamaBlock)):
                if self.sequence_parallel and not seq_sharded:
                    if h.shape[1] % self.n_devices:
                        raise ValueError(
                            "sequence length %d doesn't divide over %d "
                            "devices" % (h.shape[1], self.n_devices))
                    h = ops.split_axis_(h, axis, self.n_devices, axis=1)
                    seq_sharded = True
                fwd = (self._tp_llama_block_forward
                       if isinstance(layer, LlamaBlock)
                       else self._tp_block_forward)
                h, p = fwd(layer, params[li], h, seq_sharded, rep_rng,
                           loc_rng, li)
                tensors.append(p)
            elif params[li]:
                # replicated-param layer: bind traced params so they train
                if hasattr(layer, "set_rng") and rep_rng is not None:
                    layer.set_rng(jax.random.fold_in(rep_rng, li))
                tensors.append(bind_traced_layer(layer, params[li]))
                h = layer.forward(h)
            else:
                if hasattr(layer, "set_rng") and rep_rng is not None:
                    # batch-path site replicated over the model axis:
                    # same mask on every device
                    layer.set_rng(jax.random.fold_in(rep_rng, li))
                h = layer.forward(h)
                tensors.append({})
        if seq_sharded:
            h = ops.gather_axis_(h, axis, self.n_devices, axis=1)
        return h, tensors

    def _tp_block_forward(self, layer, params, h, seq_sharded=False,
                          rep_rng=None, loc_rng=None, li=0):
        """Megatron head-sharded TransformerBlock forward on local shards:
        attention runs on H/n local heads with NO communication, wo/w2 are
        row-parallel. Two layouts:

        - plain TP (seq_sharded=False): h replicated; fan-outs carry the
          "f" operator (identity fwd / psum bwd), fan-ins are psums.
        - Megatron-SP (seq_sharded=True): h is sequence-sharded [B,T/n,D];
          norms/residuals run on local rows, the fan-out is an all-gather
          over the sequence (VJP = reduce-scatter) and the fan-in a
          reduce-scatter (VJP = all-gather) — same wire bytes as the psum,
          1/n the norm/residual compute and activation memory.

        Numerics == the replicated block either way.

        Dropout sites: attention probabilities are HEAD-sharded — masks use
        the model-axis-folded key (decorrelated per device, heads are
        disjoint); residual/MLP sites act on the post-fan_in activations,
        which are REPLICATED under plain TP (shared rep key — replication
        must hold) and sequence-sharded under SP (device-folded key)."""
        axis = self.axis_name
        n = self.n_devices
        p = {k: Tensor(v, requires_grad=True) for k, v in params.items()}
        b, t_loc, d = h.shape
        t = t_loc * n if seq_sharded else t_loc
        h_loc = layer.num_heads // n
        hd = layer.head_dim
        drop = (layer.is_training and loc_rng is not None
                and (layer.dropout > 0.0 or layer.attn_dropout > 0.0))
        if drop:
            k_attn = jax.random.fold_in(loc_rng, 2 * li)
            res_src = loc_rng if seq_sharded else rep_rng
            k_res1, k_res2 = jax.random.split(
                jax.random.fold_in(res_src, 2 * li + 1))
        else:
            k_attn = k_res1 = k_res2 = None

        def split_heads(x):  # [B,T,D/n] -> [B,H/n,T,hd]
            return x.reshape((b, t, h_loc, hd)).transpose((0, 2, 1, 3))

        def fan_out(x):
            if seq_sharded:
                return ops.all_gather_(x, axis, axis=1)   # Megatron g
            return ops.replicate_grad_(x, axis)           # Megatron f

        def fan_in(x):
            if seq_sharded:
                return ops.psum_scatter_(x, axis, axis=1)
            return ops.psum_(x, axis)

        xn = ops.layer_norm_(h, p["g1"], p["be1"], eps=layer.eps)
        xf = fan_out(xn)
        q = split_heads(xf @ p["wq"])
        k = split_heads(xf @ p["wk"])
        v = split_heads(xf @ p["wv"])
        scores = (q @ k.transpose((0, 1, 3, 2))) * (1.0 / np.sqrt(hd))
        mask = layer._mask(t)
        if mask is not None:
            scores = scores + mask
        attn = ops.softmax_(scores, axis=-1)
        if drop and layer.attn_dropout > 0.0:
            attn = ops.dropout_(attn, layer.attn_dropout, k_attn)
        ctx = (attn @ v).transpose((0, 2, 1, 3)).reshape((b, t, d // n))
        attn_out = fan_in(ctx @ p["wo"])
        if drop and layer.dropout > 0.0:
            attn_out = ops.dropout_(attn_out, layer.dropout, k_res1)
        x2 = h + attn_out

        yn = ops.layer_norm_(x2, p["g2"], p["be2"], eps=layer.eps)
        yf = fan_out(yn)
        y = ops.gelu_(yf @ p["w1"] + p["b1"]) @ p["w2"]
        mlp_out = fan_in(y) + p["b2"]
        if drop and layer.dropout > 0.0:
            mlp_out = ops.dropout_(mlp_out, layer.dropout, k_res2)
        out = x2 + mlp_out
        return out, p

    def _tp_llama_block_forward(self, layer, params, h, seq_sharded=False,
                                rep_rng=None, loc_rng=None, li=0):
        """Megatron head-sharded LlamaBlock forward on local shards — the
        llama-family twin of _tp_block_forward: RMSNorm replaces
        LayerNorm, RoPE rotates the local q/k heads (position tables are
        head-independent, so rotating local heads == slicing the rotated
        full set), GQA keeps Hkv/n kv heads per device — the column shard
        of wk/wv is BY KV HEAD, so each query head's kv head is local and
        attention still needs no communication — and the MLP fan-in/out
        wraps the SwiGLU pair (w1/w3 column-sharded, w2 row-sharded, no
        biases). Same collective pattern and dropout rng discipline as
        the TransformerBlock path; numerics == the replicated block."""
        from tinynn_autograd_tpu.nn.layers import _repeat_heads

        axis = self.axis_name
        n = self.n_devices
        p = {k: Tensor(v, requires_grad=True) for k, v in params.items()}
        b, t_loc, d = h.shape
        t = t_loc * n if seq_sharded else t_loc
        h_loc = layer.num_heads // n
        hkv_loc = layer.num_kv_heads // n
        group = layer.num_heads // layer.num_kv_heads
        hd = layer.head_dim
        drop = (layer.is_training and loc_rng is not None
                and (layer.dropout > 0.0 or layer.attn_dropout > 0.0))
        if drop:
            k_attn = jax.random.fold_in(loc_rng, 2 * li)
            res_src = loc_rng if seq_sharded else rep_rng
            k_res1, k_res2 = jax.random.split(
                jax.random.fold_in(res_src, 2 * li + 1))
        else:
            k_attn = k_res1 = k_res2 = None

        def split_heads(x, nh):  # [B,T,nh*hd] -> [B,nh,T,hd]
            return x.reshape((b, t, nh, hd)).transpose((0, 2, 1, 3))

        def fan_out(x):
            if seq_sharded:
                return ops.all_gather_(x, axis, axis=1)   # Megatron g
            return ops.replicate_grad_(x, axis)           # Megatron f

        def fan_in(x):
            if seq_sharded:
                return ops.psum_scatter_(x, axis, axis=1)
            return ops.psum_(x, axis)

        xn = ops.rms_norm_(h, p["g1"], eps=layer.eps)
        xf = fan_out(xn)
        q = ops.rope_(split_heads(xf @ p["wq"], h_loc),
                      base=layer.rope_base)
        k = ops.rope_(split_heads(xf @ p["wk"], hkv_loc),
                      base=layer.rope_base)
        v = split_heads(xf @ p["wv"], hkv_loc)
        if group != 1:
            k = _repeat_heads(k, group)
            v = _repeat_heads(v, group)
        scores = (q @ k.transpose((0, 1, 3, 2))) * (1.0 / np.sqrt(hd))
        mask = layer._mask(t)
        if mask is not None:
            scores = scores + mask
        attn = ops.softmax_(scores, axis=-1)
        if drop and layer.attn_dropout > 0.0:
            attn = ops.dropout_(attn, layer.attn_dropout, k_attn)
        ctx = (attn @ v).transpose((0, 2, 1, 3)).reshape((b, t, d // n))
        attn_out = fan_in(ctx @ p["wo"])
        if drop and layer.dropout > 0.0:
            attn_out = ops.dropout_(attn_out, layer.dropout, k_res1)
        x2 = h + attn_out

        yn = ops.rms_norm_(x2, p["g2"], eps=layer.eps)
        yf = fan_out(yn)
        y = (ops.silu_(yf @ p["w1"]) * (yf @ p["w3"])) @ p["w2"]
        mlp_out = fan_in(y)
        if drop and layer.dropout > 0.0:
            mlp_out = ops.dropout_(mlp_out, layer.dropout, k_res2)
        out = x2 + mlp_out
        return out, p

    # -------------------------------------------------------------- build

    def _build(self):
        loss_fn = self.model.loss
        optimizer = self.model.optimizer
        axis = self.axis_name
        data_axis = self.data_axis
        specs = self._specs

        in_param_specs = [
            {k: s for k, s in layer.items()} for layer in specs
        ]
        stochastic = any(hasattr(l, "set_rng") for l in self.net.layers)
        base_key = self._base_key

        def local_step(params, opt_state, x, y):
            rep_rng = loc_rng = None
            if stochastic:
                rep_rng = jax.random.fold_in(base_key, opt_state["t"])
                if data_axis is not None:
                    # hybrid: batch rows differ per data shard — masks
                    # must too (DataParallel's decorrelation)
                    rep_rng = jax.random.fold_in(
                        rep_rng, jax.lax.axis_index(data_axis))
                loc_rng = jax.random.fold_in(
                    rep_rng, jax.lax.axis_index(axis))
            pred, tensors = self._tp_forward(params, x, rep_rng, loc_rng)
            loss_t = loss_fn.loss(pred, Tensor(y))
            loss_t.backward()
            grads = [
                {k: t.grad for k, t in layer.items()} for layer in tensors
            ]
            # replicated-param grads were computed per shard off a
            # replicated forward: identical already EXCEPT biases of col
            # layers are sharded (fine) and 'rep' dense grads are identical.
            # Batch-path grads never leave the shard.
            if self.sequence_parallel:
                # under Megatron-SP, norms/residual biases see only the
                # LOCAL sequence rows — their replicated grads are partial
                # sums and need one all-reduce
                for li, lyr in enumerate(self.net.layers):
                    if isinstance(lyr, TransformerBlock) and grads[li]:
                        for kk in ("g1", "be1", "g2", "be2", "b2"):
                            grads[li][kk] = jax.lax.psum(
                                grads[li][kk], axis)
                    elif isinstance(lyr, LlamaBlock) and grads[li]:
                        for kk in ("g1", "g2"):  # llama has no biases
                            grads[li][kk] = jax.lax.psum(
                                grads[li][kk], axis)
            if data_axis is not None:
                # hybrid DP x TP: all-reduce grads over the data axis
                grads = jax.tree.map(
                    lambda g: jax.lax.pmean(g, axis_name=data_axis), grads)
            steps, new_opt = optimizer.update(grads, params, opt_state)
            new_params = jax.tree.map(lambda p, s: p + s, params, steps)
            loss_out = loss_t.data
            if data_axis is not None:
                loss_out = jax.lax.pmean(loss_out, axis_name=data_axis)
            return new_params, new_opt, loss_out

        param_specs = in_param_specs
        # opt state: t replicated; slots follow the param specs
        slot_specs = {
            name: param_specs for name in optimizer.slot_names
        }
        opt_spec = {"t": P(), "slots": slot_specs}

        batch_spec = P(self.data_axis) if self.data_axis else P()
        sharded = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(param_specs, opt_spec, batch_spec, batch_spec),
            out_specs=(param_specs, opt_spec, P()),
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0, 1))

    # ---------------------------------------------------------- train API

    def train_step(self, x, y):
        """One tensor-parallel fused step on a replicated batch; returns the
        loss (device scalar)."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        if not self.net.is_init:
            self.net.init(x.shape)
        if self._params is None:
            self._params = self._shard_params()
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

        batch_spec = P(self.data_axis) if self.data_axis else P()
        bsh = NamedSharding(self.mesh, batch_spec)
        x = jax.device_put(x, bsh)
        y = jax.device_put(y, bsh)
        self._params, self._opt_state, loss = self._step_fn(
            self._params, self._opt_state, x, y)
        rebind_concrete(self.net, self._params)
        return loss

    def predict(self, x):
        """TP forward (no tape) on a replicated batch."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        if self._params is None:
            self._params = self._shard_params()
        specs = self._specs

        def fwd(params, xb):
            out, _ = self._tp_forward(params, xb)
            return out.data

        sharded = jax.shard_map(
            fwd, mesh=self.mesh,
            in_specs=(specs, P()), out_specs=P(),
            check_vma=False,
        )
        rep = NamedSharding(self.mesh, P())
        out = Tensor(jax.jit(sharded)(self._params,
                                      jax.device_put(x, rep)))
        rebind_concrete(self.net, self._params)
        return out

    def gather_params(self):
        """Reassemble the full (unsharded) parameter pytree on host —
        e.g. to load back into a plain Model."""
        return [
            {name: np.asarray(arr)  # jax gathers shards transparently
             for name, arr in layer_tree.items()}
            for layer_tree in self._params
        ]

    # ----------------------------------------------------------- checkpoint

    def save(self, path):
        """Checkpoint in the plain Model format (full host-layout arrays,
        incl. optimizer state) — loadable by TensorParallel OR Model."""
        wrapper_save(self, path)

    def load(self, path):
        """Restore a Model-format checkpoint; params re-shard and the
        optimizer state re-distributes at the next train_step."""
        wrapper_load(self, path)
