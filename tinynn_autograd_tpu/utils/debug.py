"""Numerical debugging — the JAX analog of the sanitizer column in
SURVEY.md §5: jit-vs-eager cross-checks and NaN/Inf guards (the failure
modes compiled numerics actually have; there are no data races to detect in
an SPMD program).
"""

import jax
import numpy as np

from tinynn_autograd_tpu.core.tensor import Tensor


def assert_finite(tree, name="tree"):
    """Raise with the offending leaf path if any value is NaN/Inf."""
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in leaves_with_paths:
        arr = np.asarray(leaf.data if isinstance(leaf, Tensor) else leaf)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                "%s%s has %d non-finite values (shape %s)"
                % (name, jax.tree_util.keystr(path), bad, arr.shape))


def check_jit_parity(model, x, y, atol=1e-5, rtol=1e-4):
    """Cross-check the compiled fused step against the eager tape on copies
    of the model's current parameters: gradients and loss must agree.

    Returns the max absolute gradient deviation. Non-mutating (restores the
    model's params and optimizer state afterwards).
    """
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import SGD

    # host-side snapshot: the probe step DONATES its param buffers, so it
    # must run on fresh device copies, never the live layer params
    params0 = jax.tree.map(np.asarray, model.net.params_tree())

    # eager tape grads
    model.zero_grad()
    loss_e = model.loss.loss(model.forward(Tensor(jnp.asarray(x))),
                             Tensor(jnp.asarray(y)))
    loss_e.backward()
    eager_grads = [
        {k: np.asarray(v.grad) for k, v in layer.items() if v is not None}
        for layer in model.net.get_parameters()
    ]
    model.zero_grad()

    # fused step with lr=1 SGD on a throwaway model sharing the same net
    probe = Model(model.net, model.loss, SGD(lr=1.0))
    probe._params = jax.tree.map(jnp.asarray, params0)  # fresh device buffers
    probe.train_step(x, y)
    fused_grads = jax.tree.map(
        lambda before, after: np.asarray(before) - np.asarray(after),
        params0, probe._params)

    max_dev = 0.0
    for le, lf in zip(eager_grads, fused_grads):
        for k in le:
            np.testing.assert_allclose(le[k], lf[k], atol=atol, rtol=rtol)
            max_dev = max(max_dev, float(np.max(np.abs(le[k] - lf[k]))))

    # restore
    model.net.bind_params(params0)
    model._params = None
    return max_dev
