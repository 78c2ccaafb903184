"""Learning-rate schedules.

The reference's optimizer module docstring promises "learning rate
schedulers" but contains none (reference: core/optimizer.py:1); these are the
fill-in. A schedule is a callable ``t -> lr`` evaluated on the
ON-DEVICE step counter inside the jitted train step, so changing lr never
forces a recompile or a host round trip. Pass one as the ``lr`` argument of
any optimizer.
"""

import jax.numpy as jnp


class Schedule:

    def __call__(self, t):
        raise NotImplementedError


class ConstantLR(Schedule):

    def __init__(self, lr):
        self.lr = lr

    def __call__(self, t):
        return self.lr


class StepDecayLR(Schedule):
    """lr * gamma ** floor(t / step_size)."""

    def __init__(self, lr, step_size, gamma=0.1):
        self.lr = lr
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, t):
        k = jnp.floor_divide(t, self.step_size).astype(jnp.float32)
        return self.lr * self.gamma ** k


class ExponentialDecayLR(Schedule):
    """lr * decay_rate ** (t / decay_steps)."""

    def __init__(self, lr, decay_steps, decay_rate):
        self.lr = lr
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate

    def __call__(self, t):
        tf = t.astype(jnp.float32) if hasattr(t, "astype") else float(t)
        return self.lr * self.decay_rate ** (tf / self.decay_steps)


class CosineDecayLR(Schedule):
    """Cosine anneal from lr to alpha*lr over decay_steps."""

    def __init__(self, lr, decay_steps, alpha=0.0):
        self.lr = lr
        self.decay_steps = decay_steps
        self.alpha = alpha

    def __call__(self, t):
        tf = t.astype(jnp.float32) if hasattr(t, "astype") else float(t)
        frac = jnp.clip(tf / self.decay_steps, 0.0, 1.0)
        cosine = 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
        return self.lr * ((1.0 - self.alpha) * cosine + self.alpha)


class WarmupCosineLR(Schedule):
    """Linear warmup for warmup_steps, then cosine decay to alpha*lr."""

    def __init__(self, lr, warmup_steps, decay_steps, alpha=0.0):
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps
        self.alpha = alpha

    def __call__(self, t):
        tf = t.astype(jnp.float32) if hasattr(t, "astype") else float(t)
        warm = self.lr * tf / max(self.warmup_steps, 1)
        frac = jnp.clip(
            (tf - self.warmup_steps) / max(self.decay_steps - self.warmup_steps, 1),
            0.0, 1.0,
        )
        cosine = 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
        decayed = self.lr * ((1.0 - self.alpha) * cosine + self.alpha)
        return jnp.where(tf < self.warmup_steps, warm, decayed)
