"""Model: net + loss + optimizer facade (reference surface: core/model.py).

Two training paths:

1. The reference-compatible eager loop — ``zero_grad -> forward -> loss ->
   backward -> step`` with ``step()`` collecting ``param.grad`` and applying
   ``param += step`` (reference: core/model.py:45-68). Every op dispatches to
   the device eagerly; correct, but each op is its own dispatch.

2. ``train_step(x, y)`` — the compiled path. The FIRST call traces forward +
   tape backward + optimizer update into ONE jitted XLA program with param and
   optimizer-state buffers donated across steps (functional update replacing
   the reference's in-place ``__iadd__``, reference: core/model.py:58-61).
   Subsequent calls are a single device dispatch with zero host round trips;
   the loss comes back as an (unsynced) device scalar.

Checkpointing (``save``/``load``) serializes a host-side pytree of params,
optimizer state, and the step counter, with a real shape-compatibility check
(the reference's check reads a nonexistent attribute and its pickle'd tape
closures can't serialize at all — reference: core/model.py:18-35).
"""

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.utils import seeder


class Model:

    def __init__(self, net, loss, optimizer):
        self.net = net
        self.loss = loss
        self.optimizer = optimizer

        self._phase = "TRAIN"
        self._opt_state = None
        self._buffers = None  # non-trainable state threaded through jit
        self._jitted = {}     # phase/kind -> compiled fn
        self._base_key = None

    # ------------------------------------------------------------- forward

    def forward(self, inputs):
        return self.net.forward(inputs)

    def predict(self, inputs):
        """Jit-compiled inference forward (cached per phase).

        Non-trainable layer state (e.g. BatchNorm running stats) is passed
        as a traced ARGUMENT and bound at trace time, so updated statistics
        flow into the cached executable instead of being baked in as stale
        constants; the key carries the buffers' structure so the
        missing-stats fallback branch can't get pinned either."""
        inputs = jnp.asarray(inputs)
        self._ensure_init(inputs.shape)
        buffers = self.net.buffers_tree()
        key = ("predict", self._phase,
               tuple(tuple(sorted(d)) for d in buffers))
        if key not in self._jitted:
            def fwd(params, buffers, x):
                self.net.bind_params(params)
                self.net.bind_buffers(buffers)
                out = self.net.forward(Tensor(x))
                return out.data

            self._jitted[key] = jax.jit(fwd)
        tree = self._params if self._params is not None else self.net.params_tree()
        out = self._jitted[key](tree, buffers, inputs)
        self.net.bind_params(tree)  # clear tracer-backed params from tracing
        self.net.bind_buffers(buffers)
        return Tensor(out)

    # ----------------------------------------------------- fused train step

    def _ensure_init(self, input_shape):
        if not self.net.is_init:
            self.net.init(input_shape)

    def _rebind_concrete(self):
        """After a traced call, layers may hold tracer-backed Tensors from
        bind_params/bind_buffers; restore the live concrete state."""
        if self._params is not None:
            self.net.bind_params(self._params)
        if self._buffers is not None:
            self.net.bind_buffers(self._buffers)

    @property
    def _params(self):
        return getattr(self, "_params_cache", None)

    @_params.setter
    def _params(self, v):
        self._params_cache = v

    def _config_fingerprint(self):
        """Hyperparameter fingerprint of the (optimizer, loss) pair, folded
        into every compiled-train-program cache key: the compiled runners
        close over ``self.optimizer``/``self.loss``, so mutating
        ``optimizer.lr`` (or any other hyperparam) or swapping the loss
        object after the first compile must trigger a recompile instead of
        silently keeping the old program."""
        def fp(obj):
            items = []
            for k, v in sorted(vars(obj).items()):
                if k == "_state":  # live optimizer state, not config
                    continue
                if isinstance(v, (bool, int, float, str, type(None))):
                    items.append((k, v))
                elif hasattr(v, "shape") and hasattr(v, "dtype") \
                        and np.size(v) <= 65536:
                    # small array hyperparams (loss class weights, schedule
                    # tables): hash VALUES so in-place mutation of the same
                    # array triggers a recompile instead of silently reusing
                    # the program compiled against the old values
                    a = np.asarray(v)
                    items.append((k, (a.shape, str(a.dtype),
                                      hash(a.tobytes()))))
                else:
                    # schedules, dtype objects, big arrays: identity — a
                    # swapped object recompiles, in-place mutation of the
                    # same large array is out of scope
                    items.append((k, id(v)))
            return (type(obj).__name__, tuple(items))

        return (fp(self.optimizer), fp(self.loss))

    def _prepare_state(self):
        """Materialize the fused-path state, staying coherent with the eager
        optimizer facade: adopt its state if it already stepped, and every
        fused update is pushed back via load_state_dict, so eager and fused
        training can interleave without silently resetting moments."""
        if self._params is None:
            self._params = self.net.params_tree()
        # buffers re-read from the layers EVERY time: eager TRAIN forwards
        # commit EMA updates into layer state without invalidating the
        # fused cache, so the layers (kept in sync by _rebind_concrete
        # after every fused call) are the single source of truth
        self._buffers = self.net.buffers_tree()
        if self._opt_state is None:
            existing = self.optimizer.state_dict()
            self._opt_state = (existing if existing is not None
                               else self.optimizer.init_state(self._params))
        if self._base_key is None:
            self._base_key = seeder.next_key()

    def train_step(self, x, y, accum_steps=1):
        """One fused optimization step; returns the loss as a device scalar
        (no host sync — wrap in float() to block).

        ``accum_steps > 1`` enables gradient accumulation: the batch is
        split into ``accum_steps`` equal microbatches scanned on-device,
        their gradients averaged, and ONE optimizer update applied — the
        standard large-effective-batch recipe when activations for the
        full batch exceed HBM (compose with ``nn.layers.Remat`` for the
        per-block activation lever). For mean-reduction losses the update
        matches the full-batch step exactly (up to summation order);
        stochastic layers draw fresh masks per microbatch. The batch size
        must divide evenly. No reference counterpart (the reference
        trains strictly one batch per update, reference
        examples/mnist/run.py:76-84)."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        if accum_steps > 1 and (x.shape[0] % accum_steps
                                or y.shape[0] % accum_steps):
            raise ValueError(
                "batch %d not divisible by accum_steps=%d"
                % (x.shape[0], accum_steps))
        self._ensure_init(x.shape)
        self._prepare_state()

        if self._phase != "TRAIN":
            self.set_phase("TRAIN")

        key = ("train_step", accum_steps, self._config_fingerprint())
        if key not in self._jitted:
            self.net.set_phase("TRAIN")
            self._jitted[key] = jax.jit(
                self._step_core(accum_steps=accum_steps),
                donate_argnums=(0, 1, 2))

        self._params, self._opt_state, self._buffers, loss = self._jitted[
            key](self._params, self._opt_state, self._buffers, x, y)
        self.optimizer.load_state_dict(self._opt_state)
        self._rebind_concrete()
        return loss

    def _step_core(self, accum_steps=1):
        """The pure fused step: forward + tape backward + optimizer update,
        with non-trainable buffers (BatchNorm running stats) threaded
        in/out so fused training maintains them like eager training does.
        Shared by the per-step jit and the scanned epoch.

        ``accum_steps > 1``: gradient accumulation — an inner ``lax.scan``
        over equal microbatches (one traced tape walk, k on-device
        iterations), gradients MEANED so mean-reduction losses match the
        full-batch step, one optimizer update."""
        net, loss_fn, optimizer = self.net, self.loss, self.optimizer
        base_key = self._base_key

        def step_fn(params, opt_state, buffers, xb, yb):
            rng = jax.random.fold_in(base_key, opt_state["t"])
            if accum_steps == 1:
                net.bind_params(params)
                net.bind_buffers(buffers)
                pred = net.forward(Tensor(xb), rng=rng)
                new_buffers = net.collect_buffer_updates()
                loss_t = loss_fn.loss(pred, Tensor(yb))
                loss_t.backward()
                grads = net.collect_grads()
                loss_val = loss_t.data
            else:
                k = accum_steps
                xmb = xb.reshape((k, xb.shape[0] // k) + xb.shape[1:])
                ymb = yb.reshape((k, yb.shape[0] // k) + yb.shape[1:])

                def micro(bufs, inp):
                    x_i, y_i, i = inp
                    net.bind_params(params)
                    net.bind_buffers(bufs)
                    pred = net.forward(
                        Tensor(x_i), rng=jax.random.fold_in(rng, i))
                    bufs_out = net.collect_buffer_updates()
                    loss_t = loss_fn.loss(pred, Tensor(y_i))
                    loss_t.backward()
                    return bufs_out, (net.collect_grads(), loss_t.data)

                new_buffers, (gstack, losses) = jax.lax.scan(
                    micro, buffers, (xmb, ymb, jnp.arange(k)))
                grads = jax.tree.map(lambda g: jnp.mean(g, axis=0), gstack)
                loss_val = jnp.mean(losses)
            steps, new_opt_state = optimizer.update(grads, params, opt_state)
            new_params = jax.tree.map(lambda p, s: p + s, params, steps)
            return new_params, new_opt_state, new_buffers, loss_val

        return step_fn

    def stage(self, x, y=None):
        """Move data into device HBM once; returns device array(s). Feed the
        result to ``train_epoch`` so epochs run with ZERO host->device
        traffic (the usual bottleneck when the host link is slow)."""
        x = jnp.asarray(x.data if isinstance(x, Tensor) else x)
        if y is None:
            return jax.device_put(x)
        y = jnp.asarray(y.data if isinstance(y, Tensor) else y)
        return jax.device_put(x), jax.device_put(y)

    def train_epoch(self, x_all, y_all, batch_size=128, shuffle=True):
        """One full epoch as ONE device dispatch: an on-device shuffle
        (jax.random.permutation gather at HBM bandwidth) followed by
        ``lax.scan`` of the fused train step over the batched dataset.

        This replaces the reference's per-batch Python loop (reference:
        examples/mnist/run.py:76-84): no per-step dispatch, no per-step
        host<->device transfer — one launch per epoch. The ragged tail
        (n % batch_size) is dropped, like BatchIterator(drop_last=True).

        Returns the per-step loss trace as a device array [n_steps].
        """
        return self.train_epochs(x_all, y_all, n_epochs=1,
                                 batch_size=batch_size, shuffle=shuffle)[0]

    def train_epochs(self, x_all, y_all, n_epochs, batch_size=128,
                     shuffle=True):
        """``n_epochs`` full epochs as ONE device dispatch: an outer
        ``lax.scan`` over per-epoch PRNG keys around the epoch body, so
        per-dispatch latency is paid once for the whole run. Returns the
        loss trace [n_epochs, n_steps]."""
        x_all = jnp.asarray(x_all.data if isinstance(x_all, Tensor) else x_all)
        y_all = jnp.asarray(y_all.data if isinstance(y_all, Tensor) else y_all)
        self._ensure_init((batch_size,) + x_all.shape[1:])
        self._prepare_state()
        if self._phase != "TRAIN":
            self.set_phase("TRAIN")

        n = x_all.shape[0]
        n_steps = n // batch_size
        if n_steps == 0:
            raise ValueError(
                "dataset of %d samples is smaller than batch_size=%d "
                "(the ragged tail is dropped; nothing would train)"
                % (n, batch_size))

        key = ("train_epochs", n_epochs, batch_size, bool(shuffle), n,
               x_all.shape[1:], str(x_all.dtype),
               y_all.shape[1:], str(y_all.dtype),
               self._config_fingerprint())
        if key not in self._jitted:
            self.net.set_phase("TRAIN")
            epoch_body = self._make_epoch_body(
                n, n_steps, batch_size, shuffle,
                x_all.shape[1:], y_all.shape[1:])

            def runner(params, opt_state, buffers, xs, ys, rng):
                def body(carry, ekey):
                    params, opt_state, buffers = carry
                    params, opt_state, buffers, losses = epoch_body(
                        params, opt_state, buffers, xs, ys, ekey)
                    return (params, opt_state, buffers), losses

                keys = jax.random.split(rng, n_epochs)
                (params, opt_state, buffers), losses = jax.lax.scan(
                    body, (params, opt_state, buffers), keys)
                return params, opt_state, buffers, losses

            self._jitted[key] = jax.jit(runner, donate_argnums=(0, 1, 2))

        rng = seeder.next_key()
        self._params, self._opt_state, self._buffers, losses = self._jitted[
            key](self._params, self._opt_state, self._buffers, x_all, y_all,
                 rng)
        self.optimizer.load_state_dict(self._opt_state)
        self._rebind_concrete()
        return losses

    def _make_epoch_body(self, n, n_steps, batch_size, shuffle,
                         feat_shape, label_feat_shape):
        """Pure fn(params, opt_state, buffers, xs, ys, rng) -> (params,
        opt_state, buffers, losses[n_steps]): on-device shuffle, then a
        lax.scan of the fused step (buffers such as BatchNorm running
        statistics are threaded through every step)."""
        batch_shape = (batch_size,) + tuple(feat_shape)
        label_shape = (batch_size,) + tuple(label_feat_shape)
        step_fn = self._step_core()

        def epoch_body(params, opt_state, buffers, xs, ys, rng):
            if shuffle:
                perm = jax.random.permutation(rng, n)[: n_steps * batch_size]
            else:
                perm = jnp.arange(n_steps * batch_size)
            xb = xs[perm].reshape((n_steps,) + batch_shape)
            yb = ys[perm].reshape((n_steps,) + label_shape)

            def body(carry, batch):
                params, opt_state, buffers = carry
                params, opt_state, buffers, loss = step_fn(
                    params, opt_state, buffers, batch[0], batch[1])
                return (params, opt_state, buffers), loss

            (params, opt_state, buffers), losses = jax.lax.scan(
                body, (params, opt_state, buffers), (xb, yb))
            return params, opt_state, buffers, losses

        return epoch_body

    def fit(self, x, y, epochs=1, batch_size=128, shuffle=True,
            eval_data=None, evaluator=None, eval_every=1, verbose=True,
            target_metric=None, target_value=None):
        """High-level training loop: stages the data once, runs epochs via
        the fused one-dispatch path, optionally evaluating every
        ``eval_every`` epochs. Returns the history dict:

        - ``history["loss"]``: per-epoch MEAN loss (floats),
        - ``history["loss_final"]``: last-step loss per epoch,
        - ``history["loss_steps"]``: the full per-step trace, one array per
          epoch (the one-dispatch path computes it anyway — don't drop it),
        - ``history["eval"]``: evaluator results every ``eval_every`` epochs.

        When ``target_metric``/``target_value`` are given (e.g.
        ``"accuracy"``, 0.975) and an evaluator is wired, the loop records
        ``history["time_to_target"]`` = {"seconds", "epochs"} at the first
        eval where the metric crosses the target, and stops early."""
        x_dev, y_dev = self.stage(x, y)
        history = {"loss": [], "loss_final": [], "loss_steps": [],
                   "eval": []}
        t0 = time.perf_counter()
        for epoch in range(epochs):
            losses = np.asarray(self.train_epoch(
                x_dev, y_dev, batch_size=batch_size, shuffle=shuffle))
            history["loss_steps"].append(losses)
            history["loss"].append(float(losses.mean()))
            history["loss_final"].append(float(losses[-1]))
            line = "epoch %d  loss %.4f (mean %.4f)" % (
                epoch, history["loss_final"][-1], history["loss"][-1])
            if (eval_data is not None and evaluator is not None
                    and (epoch + 1) % eval_every == 0):
                res = self.evaluate_batch(eval_data[0], eval_data[1],
                                          evaluator)
                history["eval"].append(res)
                line += "  %s" % res
                if (target_metric is not None and target_value is not None
                        and res.get(target_metric, -np.inf) >= target_value):
                    history["time_to_target"] = {
                        "seconds": time.perf_counter() - t0,
                        "epochs": epoch + 1,
                        target_metric: res[target_metric],
                    }
                    if verbose:
                        print(line + "  [target %s>=%s reached]"
                              % (target_metric, target_value))
                    break
            if verbose:
                print(line)
        return history

    def export_stablehlo(self, path, example_input):
        """Serving path: serialize the jitted inference forward (params baked
        in) as portable StableHLO via jax.export — loadable in any
        jax.export-compatible runtime without this framework."""
        from jax import export as jax_export

        example_input = jnp.asarray(
            example_input.data if isinstance(example_input, Tensor)
            else example_input)
        self._ensure_init(example_input.shape)
        tree = self._params if self._params is not None else self.net.params_tree()
        net = self.net

        def fwd(x):
            net.bind_params(tree)
            return net.forward(Tensor(x)).data

        exported = jax_export.export(jax.jit(fwd))(
            jax.ShapeDtypeStruct(example_input.shape, example_input.dtype))
        data = exported.serialize()
        with open(path, "wb") as f:
            f.write(data)
        self.net.bind_params(tree)  # clear tracer-backed params
        return path

    def evaluate_batch(self, x, y, evaluator):
        """Jitted TEST-phase forward + argmax for classification eval;
        restores the prior phase."""
        prev = self._phase
        if prev != "TEST":
            self.set_phase("TEST")
        preds = self.predict(x)
        if prev != "TEST":
            self.set_phase(prev)
        pred_idx = np.argmax(preds.numpy(), axis=1)
        targets = y.numpy() if isinstance(y, Tensor) else np.asarray(y)
        return evaluator.evaluate(pred_idx, targets)

    # ------------------------------------------- reference-style eager step

    def step(self):
        """Collect grads, compute optimizer steps, apply in place
        (reference contract: core/model.py:45-61)."""
        self._invalidate_fused()
        params = self.net.get_parameters()
        all_grads = [
            {k: v.grad for k, v in param.items()} for param in params
        ]
        steps = self.optimizer.compute_step(all_grads, params)
        for step, param in zip(steps, params):
            for k in param.keys():
                param[k] += step[k]

    def zero_grad(self):
        for param in self.net.get_parameters():
            for p in param.values():
                if p is not None:
                    p.zero_grad()

    def _invalidate_fused(self):
        """Eager mutation makes the cached fused-path params and optimizer
        state stale; drop both so the next fused call re-adopts the layers'
        live params and the facade's (just-advanced) optimizer state."""
        self._params = None
        self._opt_state = None
        self._buffers = None  # eager forwards update layer buffers directly

    # ----------------------------------------------------------- checkpoint

    def save(self, path):
        if not self.net.is_init:
            raise RuntimeError(
                "Model.save before parameters exist: the net has lazy layers "
                "that were never initialized (run a forward / train step, or "
                "call net.init(input_shape) first). The reference silently "
                "pickles an empty net here (reference: core/model.py:18-21)."
            )
        params_host = jax.tree.map(np.asarray, self.net.params_tree())
        # the eager step() path invalidates the fused-path cache
        # (self._opt_state = None) while the optimizer facade keeps the live
        # state — fall back to it so eager-trained models resume with their
        # moments and bias-correction schedule intact
        opt_state = (self._opt_state if self._opt_state is not None
                     else self.optimizer.state_dict())
        opt_state_host = (
            jax.tree.map(np.asarray, opt_state)
            if opt_state is not None else None
        )
        payload = {
            "format": "tinynn_tpu_ckpt_v1",
            "params": params_host,
            "opt_state": opt_state_host,
            "buffers": jax.tree.map(np.asarray, self.net.buffers_tree()),
            "layer_names": [l.name for l in self.net.layers],
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        print("Model saved in %s." % path)

    def load(self, path):
        with open(path, "rb") as f:
            payload = pickle.load(f)
        params = payload["params"]
        # shape compatibility check (the reference intended this but reads a
        # nonexistent attribute, reference: core/model.py:27-31)
        if not self.net.is_init:
            current = [
                {k: v for k, v in getattr(l, "shapes", {}).items()}
                for l in self.net.layers
            ]
        else:
            current = [
                {k: tuple(v.shape) for k, v in l.params.items() if v is not None}
                for l in self.net.layers
            ]
        if len(params) != len(self.net.layers):
            raise ValueError(
                "Incompatible architecture: %d layers in checkpoint vs %d "
                "defined." % (len(params), len(self.net.layers)))
        for i, (saved, layer) in enumerate(zip(params, self.net.layers)):
            have = current[i]
            for k, arr in saved.items():
                want = have.get(k)
                want = tuple(want) if want is not None else None
                if want is not None and None not in want and want != tuple(arr.shape):
                    raise ValueError(
                        "Incompatible architecture at layer %d (%s/%s): "
                        "%s in checkpoint vs %s defined."
                        % (i, layer.name, k, tuple(arr.shape), want))
        # install
        for layer, saved in zip(self.net.layers, params):
            for k, arr in saved.items():
                layer.params[k] = Tensor(jnp.asarray(arr), requires_grad=True)
            if hasattr(layer, "_is_init") and saved:
                layer._is_init = True
                if "w" in saved:
                    layer.shapes["w"] = list(np.asarray(saved["w"]).shape)
        if payload.get("buffers"):
            # non-trainable state (e.g. BatchNorm running stats)
            for layer, tree in zip(self.net.layers, payload["buffers"]):
                for k, arr in tree.items():
                    layer.buffers[k] = jnp.asarray(arr)
                if (tree and "count" not in tree
                        and "count" in getattr(layer, "buffers", {})):
                    # pre-"count" checkpoint carrying live stats: mark the
                    # EMA as updated so TEST uses them, not the fallback
                    layer.buffers["count"] = jnp.ones((), jnp.float32)
        if payload.get("opt_state") is not None:
            self._opt_state = jax.tree.map(jnp.asarray, payload["opt_state"])
            self.optimizer.load_state_dict(self._opt_state)
        else:
            # weights-only checkpoint: drop any live optimizer state so the
            # restored params don't train against another run's moments
            self._opt_state = None
            self.optimizer.load_state_dict(None)
        self._params = None
        self._buffers = None
        self._jitted = {k: v for k, v in self._jitted.items()
                        if k[0] != "train_step"}
        print("Restored model from %s." % path)

    # ---------------------------------------------------------------- phase

    def get_phase(self):
        return self._phase

    def set_phase(self, phase):
        assert phase in ("TRAIN", "TEST")
        self.net.set_phase(phase)
        self._phase = phase
