"""Pipeline parallelism: GPipe-style staged training over a mesh axis.

The deep-MLP body is partitioned into S contiguous stages, one per mesh
device; microbatches flow through the pipeline with activations handed to
the next stage by ``ppermute``. The key design point: NO separate
backward schedule is written. The whole tick loop is a single tape
primitive (``ops.pipeline_scan_``) whose hand VJP is the mirrored reverse
scan — cotangents re-cross the same ppermute links in reverse — and the
collectives around it (``psum_``, ``all_gather_``, ``psum_scatter_``) are
tape primitives too, so the ordinary reverse tape walk generates the whole
backward pipeline.

SPMD layout
-----------
- body weights: stacked [S, k, W, W] (k layers per stage), sharded on the
  leading stage axis -> each device holds its own stage slice;
- input projection + classifier head: replicated params. Their COMPUTE is
  hoisted out of the tick loop entirely and batched over all M microbatches
  at once; when M divides by S it is additionally sharded over the mesh —
  each device projects M/S microbatches (``all_gather_`` reassembles the
  pipeline input) and classifies M/S outputs (``psum_scatter_`` deals each
  device its slice of the last stage's outputs). The round-1 version
  recomputed proj EVERY tick on EVERY stage and head+loss every output
  tick; both redundancies are gone.
- schedule: ticks t = 0 .. M+S-2 inside ONE ``lax.scan`` (compile time
  independent of M; round 1 Python-unrolled the ticks). At tick t device s
  works on microbatch t-s; bubble slots carry exact zeros and contribute
  zero gradient.
- loss: mean over all M*mb rows (= the single-device full-batch loss),
  psum-replicated.

Scope: uniform Dense(+ReLU/Tanh/Sigmoid) bodies (the deep-MLP family,
driver config #3); microbatch count M >= S recommended to keep bubbles
small, M a multiple of S to enable the sharded proj/head path.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.nn.layers import Activation, Dense
from tinynn_autograd_tpu.parallel._common import adopt_pending_opt
from tinynn_autograd_tpu.parallel.mesh import make_mesh

_ACT_NAMES = {"ReLU": "relu", "Tanh": "tanh", "Sigmoid": "sigmoid"}


class PipelineParallel:
    """Usage::

        net = build_deep_mlp(num_in=64, depth=18, width=128, num_out=10)
        model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3))
        pp = PipelineParallel(model, mesh=make_mesh(8, axis_name="pp"),
                              microbatches=8)
        loss = pp.train_step(x, y)    # global batch, replicated
    """

    def __init__(self, model, mesh=None, n_stages=None, axis_name="pp",
                 microbatches=8):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(
            n_stages, axis_name)
        self.axis_name = axis_name
        self.n_stages = int(self.mesh.devices.size)
        self.microbatches = microbatches
        self._params = None
        self._opt_state = None
        self._step_fn = None

    @property
    def net(self):
        return self.model.net

    # ---------------------------------------------------------- partition

    def _partition(self):
        """Split net.layers into (proj_layers, body groups, head_layers).

        body = the square (W x W) Dense layers between the first and last
        Dense, each carrying its trailing activation layer; must divide
        evenly into n_stages stages and share ONE activation kind (the tick
        scan stacks the layers, so the act must be uniform).
        """
        layers = self.net.layers
        dense_idx = [i for i, l in enumerate(layers) if isinstance(l, Dense)]
        if len(dense_idx) < 3:
            raise ValueError("pipeline needs at least proj + body + head")
        for l in layers:
            if not isinstance(l, (Dense, Activation)):
                raise ValueError(
                    "PipelineParallel supports Dense/Activation stacks; "
                    "got %s" % l.name)

        first, last = dense_idx[0], dense_idx[-1]
        proj = layers[: dense_idx[1]]          # first dense + its acts
        head = layers[last:]                   # last dense (+ trailing acts)
        body_units = []                        # (dense, [acts]) groups
        for a, b in zip(dense_idx[1:-1], dense_idx[2:]):
            body_units.append(layers[a:b])

        widths = {tuple(u[0].shapes["w"]) for u in body_units}
        if len(widths) != 1:
            raise ValueError("body Dense layers must share one shape, got %s"
                             % widths)
        w_shape = widths.pop()
        if w_shape[0] != w_shape[1]:
            raise ValueError("body Dense layers must be square, got %s"
                             % (w_shape,))
        if len(body_units) % self.n_stages:
            raise ValueError(
                "%d body layers don't divide into %d stages"
                % (len(body_units), self.n_stages))

        act_names = set()
        for u in body_units:
            acts = u[1:]
            if len(acts) > 1:
                raise ValueError("at most one activation per body Dense")
            if not acts:
                act_names.add("linear")
            elif acts[0].name in _ACT_NAMES:
                act_names.add(_ACT_NAMES[acts[0].name])
            else:
                raise ValueError(
                    "body activation %s not supported in the pipeline tick "
                    "scan (ReLU/Tanh/Sigmoid)" % acts[0].name)
        if len(act_names) != 1:
            raise ValueError("body activations must be uniform, got %s"
                             % act_names)
        return proj, body_units, head, w_shape[0], act_names.pop()

    def _shard_params(self):
        proj, body_units, head, width, act_name = self._partition()
        self._proj_layers = proj
        self._head_layers = head
        self._act_name = act_name
        k = len(body_units) // self.n_stages

        def stacked(name):
            arrs = [u[0].params[name].data for u in body_units]
            return jnp.stack(arrs).reshape(
                (self.n_stages, k) + arrs[0].shape)

        sharding = NamedSharding(self.mesh, P(self.axis_name))
        rep = NamedSharding(self.mesh, P())
        params = {
            "body": {
                "w": jax.device_put(stacked("w"), sharding),
                "b": jax.device_put(stacked("b"), sharding),
            },
            "proj": {
                i: {n: jax.device_put(l.params[n].data, rep)
                    for n in l.params}
                for i, l in enumerate(proj) if isinstance(l, Dense)
            },
            "head": {
                i: {n: jax.device_put(l.params[n].data, rep)
                    for n in l.params}
                for i, l in enumerate(head) if isinstance(l, Dense)
            },
        }
        self._k = k
        self._width = width
        return params

    # -------------------------------------------------------------- build

    def _run_segment(self, layers, params_for_segment, h):
        """Replicated proj/head segment forward on Tensor h; returns
        (output, dict of param Tensors for grad collection)."""
        tensors = {}
        for i, layer in enumerate(layers):
            if isinstance(layer, Dense):
                w = Tensor(params_for_segment[i]["w"], requires_grad=True)
                b = Tensor(params_for_segment[i]["b"], requires_grad=True)
                tensors[i] = {"w": w, "b": b}
                h = h @ w + b
            else:
                h = layer.forward(h)
        return h, tensors

    def _build(self, mb_size, feat, n_out):
        loss_fn = self.model.loss
        optimizer = self.model.optimizer
        axis = self.axis_name
        S = self.n_stages
        M = self.microbatches
        width = self._width
        act_name = self._act_name
        proj_layers = self._proj_layers
        head_layers = self._head_layers
        shard_mb = (M % S == 0)   # shard proj/head compute over microbatches
        Ms = M // S if shard_mb else M

        def local_step(params, opt_state, x, y):
            # local stage slice [1, k, W, W] -> Tensors carrying the tape
            body_w = Tensor(params["body"]["w"][0], requires_grad=True)
            body_b = Tensor(params["body"]["b"][0], requires_grad=True)

            idx = jax.lax.axis_index(axis)
            is_last = (idx == S - 1)

            # ---- proj: ONE batched matmul over all (local) microbatches,
            # hoisted out of the tick loop; sharded over the mesh when M%S==0
            if shard_mb:
                x_loc = jax.lax.dynamic_slice_in_dim(x, idx * Ms, Ms, 0)
            else:
                x_loc = x
            x_flat = x_loc.reshape((Ms * mb_size, feat))
            h_flat, proj_tensors = self._run_segment(
                proj_layers, params["proj"], Tensor(x_flat))
            if shard_mb:
                h_flat = ops.all_gather_(h_flat, axis)  # [M*mb, W] replicated
            h0 = h_flat.reshape((M, mb_size, width))

            # ---- the pipeline: one scan primitive, backward by its VJP
            out = ops.pipeline_scan_(h0, body_w, body_b, axis, S, M,
                                     activation=act_name)

            # ---- head + loss: batched over microbatches, outside the loop.
            # Only the last stage's outputs are real; mask the rest so no
            # gradient flows through garbage rows.
            masked = ops.where(is_last, out,
                               Tensor(jnp.zeros_like(out.data)))
            if shard_mb:
                # deal each device its M/S slice of the REAL outputs
                out_loc = ops.psum_scatter_(masked, axis)   # [Ms, mb, W]
                y_loc = jax.lax.dynamic_slice_in_dim(y, idx * Ms, Ms, 0)
                logits, head_tensors = self._run_segment(
                    head_layers, params["head"],
                    out_loc.reshape((Ms * mb_size, width)))
                per = loss_fn.loss(logits,
                                   Tensor(y_loc.reshape((Ms * mb_size,
                                                         n_out))))
                # mean of per-chunk means == global mean (equal chunks)
                loss_rep = ops.psum_(per / S, axis)
            else:
                logits, head_tensors = self._run_segment(
                    head_layers, params["head"],
                    masked.reshape((M * mb_size, width)))
                per = loss_fn.loss(logits,
                                   Tensor(y.reshape((M * mb_size, n_out))))
                masked_loss = ops.where(is_last, per,
                                        Tensor(jnp.zeros((), jnp.float32)))
                loss_rep = ops.psum_(masked_loss, axis)
            loss_rep.backward()

            def seg_grads(tensors, seg_params):
                # psum makes the per-device partial grads total AND
                # replicated: sharded-mb chunks sum to the full-batch grad;
                # in the masked path only one device's grads are nonzero
                out = {}
                for i in seg_params:
                    out[i] = {"w": jax.lax.psum(tensors[i]["w"].grad, axis),
                              "b": jax.lax.psum(tensors[i]["b"].grad, axis)}
                return out

            grads = {
                "body": {"w": body_w.grad[None], "b": body_b.grad[None]},
                "proj": seg_grads(proj_tensors, params["proj"]),
                "head": seg_grads(head_tensors, params["head"]),
            }

            steps, new_opt = optimizer.update(grads, params, opt_state)
            new_params = jax.tree.map(lambda p, s: p + s, params, steps)
            return new_params, new_opt, loss_rep.data

        param_specs = {
            "body": {"w": P(axis), "b": P(axis)},
            "proj": jax.tree.map(lambda _: P(), dict(self._spec_template("proj"))),
            "head": jax.tree.map(lambda _: P(), dict(self._spec_template("head"))),
        }
        opt_spec = {
            "t": P(),
            "slots": {name: param_specs
                      for name in optimizer.slot_names},
        }
        sharded = jax.shard_map(
            local_step, mesh=self.mesh,
            in_specs=(param_specs, opt_spec, P(), P()),
            out_specs=(param_specs, opt_spec, P()),
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0, 1))

    def _spec_template(self, seg):
        return {i: {n: 0 for n in leafs}
                for i, leafs in self._params[seg].items()}

    # ---------------------------------------------------------- train API

    def train_step(self, x, y):
        """One pipelined fused step on a replicated global batch (size must
        divide by ``microbatches``). Returns the mean loss."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        if not self.net.is_init:
            self.net.init(x.shape)
        M = self.microbatches
        if x.shape[0] % M:
            raise ValueError("batch %d not divisible by %d microbatches"
                             % (x.shape[0], M))
        mb = x.shape[0] // M
        xm = x.reshape((M, mb) + x.shape[1:])
        ym = y.reshape((M, mb) + y.shape[1:])

        if self._params is None:
            self._params = self._shard_params()
        if self._opt_state is None:
            self._opt_state = adopt_pending_opt(self, self._stack_opt_state)
        if self._step_fn is None:
            self.model.set_phase("TRAIN")
            self._step_fn = self._build(mb, x.shape[1], y.shape[1])

        rep = NamedSharding(self.mesh, P())
        xm = jax.device_put(xm, rep)
        ym = jax.device_put(ym, rep)
        self._params, self._opt_state, loss = self._step_fn(
            self._params, self._opt_state, xm, ym)
        return loss

    def gather_params(self):
        """Host copies: {body: [S,k,...] stacked arrays, proj/head dicts}."""
        return jax.tree.map(np.asarray, self._params)

    # ----------------------------------------------------------- checkpoint

    def _layer_tree_from_pp(self, tree):
        """PP-structured {body, proj, head} -> layer-congruent list-of-dicts
        of full host arrays (body [S, k, ...] unstacked back into per-layer
        leaves in net.layers order)."""
        layers = self.net.layers
        dense_idx = [i for i, l in enumerate(layers) if isinstance(l, Dense)]
        last = dense_idx[-1]
        out = [{} for _ in layers]
        for i, sub in tree["proj"].items():
            out[i] = {k: np.asarray(v) for k, v in sub.items()}
        for i, sub in tree["head"].items():
            out[last + i] = {k: np.asarray(v) for k, v in sub.items()}
        w = np.asarray(tree["body"]["w"])
        b = np.asarray(tree["body"]["b"])
        w = w.reshape((-1,) + w.shape[2:])
        b = b.reshape((-1,) + b.shape[2:])
        for j, li in enumerate(dense_idx[1:-1]):
            out[li] = {"w": w[j], "b": b[j]}
        return out

    def _pp_tree_from_layers(self, tree):
        """layer-congruent list-of-dicts of full arrays -> PP-structured
        sharded tree (body restacked [S, k, ...] and split on the stage
        axis; proj/head replicated)."""
        layers = self.net.layers
        dense_idx = [i for i, l in enumerate(layers) if isinstance(l, Dense)]
        last = dense_idx[-1]
        sharding = NamedSharding(self.mesh, P(self.axis_name))
        rep = NamedSharding(self.mesh, P())

        def stacked(name):
            arrs = [jnp.asarray(tree[li][name]) for li in dense_idx[1:-1]]
            return jax.device_put(
                jnp.stack(arrs).reshape(
                    (self.n_stages, self._k) + arrs[0].shape), sharding)

        return {
            "body": {"w": stacked("w"), "b": stacked("b")},
            "proj": {i: {n: jax.device_put(jnp.asarray(v), rep)
                         for n, v in tree[i].items()}
                     for i in range(dense_idx[1]) if tree[i]},
            "head": {i: {n: jax.device_put(jnp.asarray(v), rep)
                         for n, v in tree[last + i].items()}
                     for i in range(len(layers) - last) if tree[last + i]},
        }

    def _stack_opt_state(self, host):
        """Checkpointed (layer-congruent) optimizer state -> PP layout."""
        rep = NamedSharding(self.mesh, P())
        return {
            "t": jax.device_put(jnp.asarray(host["t"]), rep),
            "slots": {n: self._pp_tree_from_layers(tree)
                      for n, tree in host["slots"].items()},
        }

    def save(self, path):
        """Checkpoint in the plain Model format: the stage-sharded body
        stack is unstacked back into per-layer full arrays, so the file
        loads into a fresh PipelineParallel OR a single-device Model."""
        if self._params is not None:
            host = self._layer_tree_from_pp(self._params)
            for layer, d in zip(self.net.layers, host):
                for k, arr in d.items():
                    layer.params[k] = Tensor(jnp.asarray(arr),
                                             requires_grad=True)
            if self._opt_state is not None:
                self.model._opt_state = {
                    "t": self._opt_state["t"],
                    "slots": {
                        n: self._layer_tree_from_pp(
                            self._opt_state["slots"][n])
                        for n in self.model.optimizer.slot_names
                    },
                }
        self.model.save(path)

    def load(self, path):
        """Restore a Model-format checkpoint; the body restacks and
        re-shards over the stage axis at the next train_step."""
        self.model.load(path)
        self._params = None
        self._opt_state = None
        self._step_fn = None
        self._pending_opt = self.model._opt_state
