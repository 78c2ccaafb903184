"""Data parallelism: batch-sharded fused train step with a gradient pmean
across devices (the reference is strictly single-device, SURVEY.md §2.2).

Design: ``shard_map`` over a 1-D mesh. Each device runs the SAME fused
forward + tape-backward + optimizer program (see nn/model.py) on its batch
shard; the only cross-device traffic is one ``pmean`` of the gradient pytree
(XLA lowers it to an all-reduce, NCCL on GPUs) between the tape walk and the
optimizer update, plus a scalar pmean for the reported loss. Params and
optimizer state are replicated, stay resident in device memory, and are
donated across steps.

Because each shard's loss divides by the LOCAL batch size, pmean of the shard
gradients equals the gradient of the global-mean loss — training is
numerically equivalent (up to reduction order) to single-device training on
the full batch, which the tests verify on a simulated 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.parallel.mesh import make_mesh
from tinynn_autograd_tpu.utils import seeder


class DataParallel:
    """Wrap a Model for mesh data-parallel training.

    Usage::

        model = Model(net, loss, optimizer)
        dp = DataParallel(model, mesh=make_mesh())   # or n_devices=8
        loss = dp.train_step(x, y)                   # global batch in, loss out
    """

    def __init__(self, model, mesh=None, n_devices=None, axis_name="data"):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(n_devices, axis_name)
        self.axis_name = axis_name
        self.n_devices = self.mesh.devices.size
        self._params = None
        self._opt_state = None
        self._step_fns = {}  # keyed by accum_steps
        self._base_key = None

    # -------------------------------------------------------------- helpers

    @property
    def net(self):
        return self.model.net

    def _batch_sharding(self):
        return NamedSharding(self.mesh, P(self.axis_name))

    def stage(self, x, y=None):
        """Shard data across the mesh's HBM once (leading dim split over the
        data axis); feed the result to train_epoch/train_step so epochs run
        without re-uploading the dataset."""
        sharding = self._batch_sharding()
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        if y is None:
            return jax.device_put(x, sharding)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        return jax.device_put(x, sharding), jax.device_put(y, sharding)

    def _place(self, arr):
        sharding = self._batch_sharding()
        if isinstance(arr, jax.Array) and arr.sharding == sharding:
            return arr
        return jax.device_put(arr, sharding)

    def _ensure_init(self, input_shape):
        if not self.net.is_init:
            self.net.init(input_shape)

    def _build(self, accum_steps=1):
        net = self.net
        loss_fn = self.model.loss
        optimizer = self.model.optimizer
        axis = self.axis_name
        base_key = self._base_key

        def local_step(params, opt_state, xb, yb):
            # runs per device on its batch shard
            rng = jax.random.fold_in(base_key, opt_state["t"])
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
            if accum_steps == 1:
                net.bind_params(params)
                pred = net.forward(Tensor(xb), rng=rng)
                loss_t = loss_fn.loss(pred, Tensor(yb))
                loss_t.backward()
                grads = net.collect_grads()
                loss_local = loss_t.data
            else:
                # gradient accumulation: scan the local shard's k
                # microbatches, mean grads — one pmean + update per
                # GLOBAL step, same as the single-device recipe
                # (nn/model.py _step_core)
                k = accum_steps
                xm = xb.reshape((k, xb.shape[0] // k) + xb.shape[1:])
                ym = yb.reshape((k, yb.shape[0] // k) + yb.shape[1:])

                def micro(carry, inp):
                    x_i, y_i, i = inp
                    net.bind_params(params)
                    pred = net.forward(
                        Tensor(x_i), rng=jax.random.fold_in(rng, i))
                    loss_t = loss_fn.loss(pred, Tensor(y_i))
                    loss_t.backward()
                    return carry, (net.collect_grads(), loss_t.data)

                _, (gstack, losses) = jax.lax.scan(
                    micro, 0, (xm, ym, jnp.arange(k)))
                grads = jax.tree.map(lambda g: jnp.mean(g, axis=0), gstack)
                loss_local = jnp.mean(losses)
            # the one collective: gradient all-reduce
            grads = jax.tree.map(
                lambda g: jax.lax.pmean(g, axis_name=axis), grads)
            steps, new_opt_state = optimizer.update(grads, params, opt_state)
            new_params = jax.tree.map(lambda p, s: p + s, params, steps)
            loss_out = jax.lax.pmean(loss_local, axis_name=axis)
            return new_params, new_opt_state, loss_out

        sharded = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(P(), P(), P(self.axis_name), P(self.axis_name)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        # via the Model facade so model._phase stays in sync — predict
        # keys its cache by phase, and a desynced phase would cache a
        # TRAIN-mode trace under the TEST key
        self.model.set_phase("TRAIN")
        return jax.jit(sharded, donate_argnums=(0, 1))

    # ------------------------------------------------------------ train API

    def train_step(self, x, y, accum_steps=1):
        """One data-parallel step on a GLOBAL batch (leading dim must divide
        by the mesh size). Returns the global mean loss (device scalar).

        ``accum_steps > 1``: each device scans its local shard in
        ``accum_steps`` microbatches and means the gradients BEFORE the
        one pmean — the large-effective-batch recipe with unchanged
        per-step collective cost (the local shard must divide evenly)."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        if x.shape[0] % self.n_devices:
            raise ValueError(
                "Global batch %d not divisible by mesh size %d"
                % (x.shape[0], self.n_devices))
        if accum_steps > 1 and (x.shape[0] // self.n_devices) % accum_steps:
            raise ValueError(
                "Local shard %d not divisible by accum_steps=%d"
                % (x.shape[0] // self.n_devices, accum_steps))
        self._ensure_init(x.shape)

        if self._params is None:
            self._params = self.net.params_tree()
        if self._opt_state is None:
            self._opt_state = self.model.optimizer.init_state(self._params)
        if self._base_key is None:
            self._base_key = seeder.next_key()
        if accum_steps not in self._step_fns:
            self._step_fns[accum_steps] = self._build(accum_steps)
            # pre-place the batch sharding so host->device transfer lands
            # each shard directly on its device
            self._x_sharding = NamedSharding(self.mesh, P(self.axis_name))

        x = self._place(x)
        y = self._place(y)
        self._params, self._opt_state, loss = self._step_fns[accum_steps](
            self._params, self._opt_state, x, y)
        self.net.bind_params(self._params)
        return loss

    def train_epoch(self, x_all, y_all, batch_size=128, shuffle=True):
        """One full data-parallel epoch as ONE dispatch: each device locally
        shuffles and scans the fused step over ITS shard of the dataset,
        pmean-ing gradients every step. ``batch_size`` is the GLOBAL
        batch. Returns the per-step global-mean loss trace."""
        return self.train_epochs(x_all, y_all, n_epochs=1,
                                 batch_size=batch_size, shuffle=shuffle)[0]

    def train_epochs(self, x_all, y_all, n_epochs, batch_size=128,
                     shuffle=True):
        """``n_epochs`` data-parallel epochs as ONE dispatch (outer
        lax.scan over per-epoch shuffle keys around the sharded epoch
        body — the DP analog of Model.train_epochs): the per-step tape
        program with a gradient ``pmean`` between backward and update.
        Returns the loss trace [n_epochs, n_steps]."""
        x_all = jnp.asarray(x_all.data if isinstance(x_all, Tensor) else x_all)
        y_all = jnp.asarray(y_all.data if isinstance(y_all, Tensor) else y_all)
        if x_all.shape[0] % self.n_devices or batch_size % self.n_devices:
            raise ValueError(
                "dataset size %d and global batch %d must divide by mesh "
                "size %d" % (x_all.shape[0], batch_size, self.n_devices))
        self._ensure_init((batch_size,) + x_all.shape[1:])

        if self._params is None:
            self._params = self.net.params_tree()
        if self._opt_state is None:
            self._opt_state = self.model.optimizer.init_state(self._params)
        if self._base_key is None:
            self._base_key = seeder.next_key()

        local_n = x_all.shape[0] // self.n_devices
        local_batch = batch_size // self.n_devices
        n_steps = local_n // local_batch

        key = ("dp_epochs", int(n_epochs), batch_size, bool(shuffle),
               x_all.shape[0], x_all.shape[1:], y_all.shape[1:])
        if not hasattr(self, "_epoch_fns"):
            self._epoch_fns = {}
        if key not in self._epoch_fns:
            net = self.net
            loss_fn = self.model.loss
            optimizer = self.model.optimizer
            axis = self.axis_name
            base_key = self._base_key

            def local_epoch(params, opt_state, xs, ys, rng):
                rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
                if shuffle:
                    perm = jax.random.permutation(rng, local_n)
                    perm = perm[: n_steps * local_batch]
                else:
                    perm = jnp.arange(n_steps * local_batch)
                xb = xs[perm].reshape(
                    (n_steps, local_batch) + xs.shape[1:])
                yb = ys[perm].reshape(
                    (n_steps, local_batch) + ys.shape[1:])

                def body(carry, batch):
                    params, opt_state = carry
                    net.bind_params(params)
                    # fold in step AND data-axis index (mirrors local_step in
                    # _build) so dropout masks differ across the mesh
                    drop_rng = jax.random.fold_in(base_key, opt_state["t"])
                    drop_rng = jax.random.fold_in(
                        drop_rng, jax.lax.axis_index(axis))
                    pred = net.forward(Tensor(batch[0]), rng=drop_rng)
                    loss_t = loss_fn.loss(pred, Tensor(batch[1]))
                    loss_t.backward()
                    grads = net.collect_grads()
                    grads = jax.tree.map(
                        lambda g: jax.lax.pmean(g, axis_name=axis), grads)
                    steps, new_opt = optimizer.update(grads, params, opt_state)
                    new_params = jax.tree.map(
                        lambda p, s: p + s, params, steps)
                    loss_out = jax.lax.pmean(loss_t.data, axis_name=axis)
                    return (new_params, new_opt), loss_out

                (params, opt_state), losses = jax.lax.scan(
                    body, (params, opt_state), (xb, yb))
                return params, opt_state, losses

            def local_run(params, opt_state, xs, ys, rng):
                def epoch_body(carry, ekey):
                    params, opt_state = carry
                    params, opt_state, losses = local_epoch(
                        params, opt_state, xs, ys, ekey)
                    return (params, opt_state), losses

                keys = jax.random.split(rng, n_epochs)
                (params, opt_state), losses = jax.lax.scan(
                    epoch_body, (params, opt_state), keys)
                return params, opt_state, losses

            sharded = jax.shard_map(
                local_run,
                mesh=self.mesh,
                in_specs=(P(), P(), P(self.axis_name), P(self.axis_name),
                          P()),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
            self.model.set_phase("TRAIN")
            self._epoch_fns[key] = jax.jit(sharded, donate_argnums=(0, 1))

        x_all = self._place(x_all)
        y_all = self._place(y_all)
        rng = seeder.next_key()
        self._params, self._opt_state, losses = self._epoch_fns[key](
            self._params, self._opt_state, x_all, y_all, rng)
        self.net.bind_params(self._params)
        return losses

    def predict(self, x):
        """Batch-sharded jitted inference over the mesh: params/buffers
        replicated, the batch split on the data axis, output sharded the
        same way (XLA partitions the collective-free forward directly; no
        shard_map needed). Batches that don't divide by the mesh fall back
        to single-device model.predict."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        if x.shape[0] % self.n_devices:
            return self.model.predict(x)
        self._ensure_init(x.shape)
        net = self.net
        params = (self._params if self._params is not None
                  else net.params_tree())
        buffers = net.buffers_tree()
        key = ("dp_predict", self.model.get_phase(), x.shape[1:],
               str(x.dtype), tuple(tuple(sorted(d)) for d in buffers))
        if not hasattr(self, "_predict_fns"):
            self._predict_fns = {}
        if key not in self._predict_fns:
            def fwd(params, buffers, xb):
                net.bind_params(params)
                net.bind_buffers(buffers)
                return net.forward(Tensor(xb)).data

            rep = NamedSharding(self.mesh, P())
            self._predict_fns[key] = jax.jit(
                fwd, in_shardings=(rep, rep, self._batch_sharding()),
                out_shardings=self._batch_sharding())
        out = self._predict_fns[key](params, buffers, x)
        net.bind_params(params)  # clear tracer-backed params from tracing
        net.bind_buffers(buffers)
        return Tensor(out)

    def save(self, path):
        self.model._params = self._params
        self.model._opt_state = self._opt_state
        self.model.save(path)

    def load(self, path):
        """Restore a Model-format checkpoint; params/optimizer state are
        replicated, so they re-enter the step directly."""
        self.model.load(path)
        self._params = None
        self._opt_state = (
            jax.tree.map(jnp.asarray, self.model._opt_state)
            if self.model._opt_state is not None else None)
        self._step_fns = {}
