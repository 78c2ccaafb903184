"""Optimizers (reference surface: core/optimizer.py) as per-leaf pytree
updates.

The reference flattens every gradient into ONE 1-D vector each step, runs the
update there, and re-slices per parameter (reference: core/optimizer.py:12-35)
— a gather/scatter round trip per step. All seven update rules are elementwise,
so per-leaf pytree updates are numerically IDENTICAL while letting XLA fuse
each parameter's update into the backward pass of the same compiled program.

Two entry points:
- ``update(grads, params, state) -> (steps, new_state)`` — pure/functional,
  traced inside the fused jitted train step (state is a pytree of device
  arrays incl. the step counter, so the whole optimizer lives on-device).
- ``compute_step(grads, params)`` — reference-compatible stateful facade
  (list-of-dicts in, list-of-dicts of steps out).

``weight_decay`` is implemented (step -= weight_decay * param — the rule the
reference declares but leaves commented out, reference: core/optimizer.py:29-30).
``lr`` may be a float or a schedule (see nn/scheduler.py) evaluated at the
on-device step counter.
"""

import builtins

import jax
import jax.numpy as jnp


def _tree_of(obj):
    """Coerce list-of-dicts possibly holding Tensors into raw-array pytree."""
    from tinynn_autograd_tpu.core.tensor import Tensor

    return jax.tree.map(
        lambda v: v.data if isinstance(v, Tensor) else jnp.asarray(v), obj
    )


class BaseOptimizer:

    # names of per-parameter state slots, e.g. ("m", "v") for Adam
    slot_names = ()

    def __init__(self, lr, weight_decay=0.0, slot_dtype=None,
                 stochastic_rounding=False, clip_norm=None):
        """``slot_dtype``: storage dtype for the per-parameter state slots
        (e.g. ``jnp.bfloat16`` to halve optimizer-state memory and the
        slot traffic of every update). The update math always runs in
        float32; only the stored moments are rounded.

        With the default round-to-nearest, bf16 storage has a real
        numerics cost: relative EMA increments below bf16's 2^-8
        resolution are dropped, so slow-moving slots (Adam's v at small
        lr*g) can stall and convergence lags the f32 twin.
        ``stochastic_rounding=True`` fixes this in expectation: random
        bits below the mantissa cutoff decide the rounding direction
        (ops.primitives.stochastic_round_cast, seeded from the on-device
        step counter + a per-leaf salt), so E[stored] == exact — the
        standard recipe for sound bf16 optimizer state.

        ``clip_norm``: global-norm gradient clipping (torch semantics:
        grads scaled by min(1, clip_norm / (||g||_2 + 1e-6)) over ALL
        leaves jointly) applied inside ``update`` before the rule — so it
        takes effect on every path that routes through update (eager
        facade, fused step, scanned epoch)."""
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.slot_dtype = slot_dtype
        self.stochastic_rounding = stochastic_rounding
        if (stochastic_rounding and slot_dtype is not None
                and jnp.dtype(slot_dtype) != jnp.bfloat16):
            # stochastic_round_cast only implements the bf16 cutoff; a
            # silent fall-through to round-to-nearest would quietly ignore
            # the flag the user asked for (e.g. slot_dtype=float16)
            raise ValueError(
                "stochastic_rounding=True is only implemented for "
                "slot_dtype=jnp.bfloat16 (got %s)" % jnp.dtype(slot_dtype))
        self._state = None

    # ------------------------------------------------------ functional API

    def init_state(self, params):
        dt = self.slot_dtype

        def zeros(p):
            return jnp.zeros(jnp.shape(p), dt if dt is not None
                             else jnp.asarray(p).dtype)

        slots = {
            name: jax.tree.map(zeros, params)
            for name in self.slot_names
        }
        return {"t": jnp.zeros((), jnp.int32), "slots": slots}

    def step_leaf(self, g, lr, t, slots, salt=0):
        """Dtype-managing wrapper around the per-leaf update rule: slots
        are upcast to f32 for the math, then new slots are stored back in
        ``slot_dtype`` — or, when no override is set, in each slot's OWN
        input dtype, so carried state keeps a stable type under lax.scan
        (e.g. bf16-param training: bf16 slots in must mean bf16 slots
        out). The step is returned in the gradient's dtype so params are
        not silently promoted. ``salt`` decorrelates the stochastic-
        rounding streams across leaves/layers. Every execution path
        (eager facade, fused step, scanned epoch) goes through here."""
        slots32 = {k: jnp.asarray(v).astype(jnp.float32)
                   for k, v in slots.items()}
        step, new = self._step_leaf(g, lr, t, slots32)
        if self.slot_dtype is not None and self.stochastic_rounding:
            from tinynn_autograd_tpu.ops.primitives import (
                stochastic_round_cast,
            )

            new = {
                k: stochastic_round_cast(
                    v, self.slot_dtype,
                    t * 1000003 + jnp.int32(salt) * 8191 + si)
                for si, (k, v) in enumerate(sorted(new.items()))
            }
        else:
            new = {
                k: v.astype(self.slot_dtype if self.slot_dtype is not None
                            else jnp.asarray(slots[k]).dtype)
                for k, v in new.items()
            }
        g_dtype = jnp.asarray(g).dtype
        return jnp.asarray(step).astype(g_dtype), new

    def _lr_at(self, t):
        if callable(self.lr):
            return self.lr(t)
        return self.lr

    def update(self, grads, params, state):
        """Pure update: returns (steps, new_state); params are NOT mutated.

        ``steps`` is what gets ADDED to params (reference sign convention:
        param += step, reference core/model.py:58-61).
        """
        t = state["t"] + 1
        lr = self._lr_at(t)

        g_leaves, treedef = jax.tree.flatten(grads)
        if self.clip_norm is not None and g_leaves:
            total = jnp.sqrt(builtins.sum(
                jnp.sum(jnp.asarray(g).astype(jnp.float32) ** 2)
                for g in g_leaves))
            scale = jnp.minimum(1.0, self.clip_norm / (total + 1e-6))
            g_leaves = [g * scale.astype(jnp.asarray(g).dtype)
                        for g in g_leaves]
        p_leaves = treedef.flatten_up_to(params)
        slot_leaves = {
            n: treedef.flatten_up_to(state["slots"][n])
            for n in self.slot_names
        }

        steps = []
        new_slots = {n: [] for n in self.slot_names}
        for i, (g, p) in enumerate(zip(g_leaves, p_leaves)):
            g = g.astype(p.dtype)
            slots_i = {n: slot_leaves[n][i] for n in self.slot_names}
            step, updated = self.step_leaf(g, lr, t, slots_i, salt=i)
            if self.weight_decay:
                step = step - self.weight_decay * p
            steps.append(step)
            for n in self.slot_names:
                new_slots[n].append(updated[n])

        new_state = {
            "t": t,
            "slots": {
                n: jax.tree.unflatten(treedef, new_slots[n])
                for n in self.slot_names
            },
        }
        return jax.tree.unflatten(treedef, steps), new_state

    def _step_leaf(self, g, lr, t, slots):
        raise NotImplementedError

    # ----------------------------------------- reference-compatible facade

    def compute_step(self, grads, params):
        """Stateful eager facade (reference contract:
        core/optimizer.py:12-35): same list-of-dicts structures in/out."""
        grads_t = _tree_of(grads)
        params_t = _tree_of(params)
        if self._state is None:
            self._state = self.init_state(params_t)
        steps, self._state = self.update(grads_t, params_t, self._state)
        return steps

    def reset(self):
        self._state = None

    def state_dict(self):
        return self._state

    def load_state_dict(self, state):
        self._state = state


class SGD(BaseOptimizer):
    """step = -lr * g (reference: core/optimizer.py:41-47)."""

    def __init__(self, lr, weight_decay=0.0, clip_norm=None):
        super().__init__(lr, weight_decay, clip_norm=clip_norm)

    def _step_leaf(self, g, lr, t, slots):
        return -lr * g, {}


class Momentum(BaseOptimizer):
    """acc = momentum * acc + g; step = -lr * acc
    (reference: core/optimizer.py:113-126)."""

    slot_names = ("acc",)

    def __init__(self, lr, momentum=0.9, weight_decay=0.0,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._momentum = momentum

    def _step_leaf(self, g, lr, t, slots):
        acc = self._momentum * slots["acc"] + g
        return -lr * acc, {"acc": acc}


class Adam(BaseOptimizer):
    """EMA moments with bias correction (reference: core/optimizer.py:50-79):
    m += (1-b1)(g - m); v += (1-b2)(g^2 - v);
    step = -lr * m_hat / (sqrt(v_hat) + eps).
    """

    slot_names = ("m", "v")

    def __init__(self, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.0, slot_dtype=None,
                 stochastic_rounding=False, clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._b1 = beta1
        self._b2 = beta2
        self._eps = epsilon

    def _step_leaf(self, g, lr, t, slots):
        m = slots["m"] + (1.0 - self._b1) * (g - slots["m"])
        v = slots["v"] + (1.0 - self._b2) * (g * g - slots["v"])
        # powf-free forms: b**t = exp(t*ln b), x**0.5 = sqrt. Bias
        # corrections are folded into SCALARS:
        #   -lr * m_hat / (sqrt(v_hat) + eps)
        #     == -(lr/c1) * m / (sqrt(v) * rsqrt(c2) + eps)
        # (identical within ~1 ulp of reassociation) — this trades the two
        # per-ELEMENT divisions for one scalar division + one elementwise
        # multiply.
        tf = t.astype(jnp.float32)
        c1 = 1.0 - jnp.exp(tf * jnp.log(self._b1))
        c2 = 1.0 - jnp.exp(tf * jnp.log(self._b2))
        step = (-(lr / c1)) * m / (jnp.sqrt(v) * jax.lax.rsqrt(c2)
                                   + self._eps)
        return step, {"m": m, "v": v}


class Lion(BaseOptimizer):
    """Lion (EvoLved Sign Momentum, Chen et al. 2023): the update is the
    SIGN of an interpolated momentum —
      u = sign(b1 * m + (1 - b1) * g);  step = -lr * u;
      m = b2 * m + (1 - b2) * g.
    One state slot (half Adam's optimizer memory and slot traffic),
    elementwise and powf-free. Typical recipe: ~10x smaller lr and ~10x
    larger weight_decay than Adam. ``weight_decay`` follows the
    framework-wide decoupled rule (step -= weight_decay * p, applied by
    the base after the rule). An addition — no reference counterpart (the
    reference zoo is SGD..Adadelta, core/optimizer.py)."""

    slot_names = ("m",)

    def __init__(self, lr=1e-4, beta1=0.9, beta2=0.99, weight_decay=0.0,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._b1 = beta1
        self._b2 = beta2

    def _step_leaf(self, g, lr, t, slots):
        u = jnp.sign(self._b1 * slots["m"] + (1.0 - self._b1) * g)
        m = self._b2 * slots["m"] + (1.0 - self._b2) * g
        return -lr * u, {"m": m}


class RMSProp(BaseOptimizer):
    """ms = decay*ms + (1-decay)*g^2;
    mom = momentum*mom + lr*g/sqrt(ms + eps); step = -mom
    (reference: core/optimizer.py:82-110)."""

    slot_names = ("ms", "mom")

    def __init__(self, lr=0.01, decay=0.99, momentum=0.0, epsilon=1e-8,
                 weight_decay=0.0, slot_dtype=None,
                 stochastic_rounding=False, clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._decay = decay
        self._momentum = momentum
        self._eps = epsilon

    def _step_leaf(self, g, lr, t, slots):
        ms = slots["ms"] + (1.0 - self._decay) * (g * g - slots["ms"])
        # g / sqrt(x) == g * rsqrt(x) within ~1 ulp; one op instead of
        # sqrt + divide
        mom = (self._momentum * slots["mom"]
               + lr * g * jax.lax.rsqrt(ms + self._eps))
        return -mom, {"ms": ms, "mom": mom}


class Adagrad(BaseOptimizer):
    """G += g^2; step = -(lr / sqrt(G + eps)) * g
    (reference: core/optimizer.py:129-144)."""

    slot_names = ("G",)

    def __init__(self, lr, weight_decay=0.0, epsilon=1e-8,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._eps = epsilon

    def _step_leaf(self, g, lr, t, slots):
        G = slots["G"] + g * g
        return -lr * g * jax.lax.rsqrt(G + self._eps), {"G": G}


class Adadelta(BaseOptimizer):
    """Zeiler 2012 (reference: core/optimizer.py:147-164):
    Eg = decay*Eg + (1-decay)*g^2; delta_step = g * sqrt(d + eps)/sqrt(Eg + eps);
    step = -lr * delta_step; d = decay*d + (1-decay)*delta_step^2.
    """

    slot_names = ("Eg", "d")

    def __init__(self, lr=1.0, weight_decay=0.0, decay=0.9, epsilon=1e-8,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._decay = decay
        self._eps = epsilon

    def _step_leaf(self, g, lr, t, slots):
        Eg = slots["Eg"] + (1.0 - self._decay) * (g * g - slots["Eg"])
        std = jnp.sqrt(slots["d"] + self._eps)
        delta = g * std * jax.lax.rsqrt(Eg + self._eps)
        step = -lr * delta
        d = slots["d"] + (1.0 - self._decay) * (delta * delta - slots["d"])
        return step, {"Eg": Eg, "d": d}
