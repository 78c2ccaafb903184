"""Tensor: a device-resident (HBM) array with tape-based reverse-mode autodiff.

Accelerator redesign of the reference Tensor (reference:
core/tensor.py:13-171).
Differences from the reference, by design:

- The payload is a ``jax.Array`` in device memory (or an XLA tracer when the
  enclosing computation is being staged by ``jax.jit``), not a numpy ndarray.
  Every op therefore works both eagerly *and* under tracing, which is what lets
  a whole train step (forward + tape walk + optimizer) compile into ONE fused
  XLA program with zero host round-trips.
- ``backward()`` is a single reverse-topological tape walk (each node visited
  exactly once), replacing the reference's recursive DFS (reference:
  core/tensor.py:157-168) which re-propagates partial gradients once per path
  and is therefore path-exponential on shared subgraphs. Observable gradient
  totals are identical.
- Gradients are accumulated as floating-point arrays (float32 by default);
  integer-valued tensors still carry float gradients.

API parity: constructor signature, ``values``/``shape``/``grad``/
``requires_grad``/``dependency`` attributes, the full dunder-operator surface,
method ops (``sum/max/min/transpose/log/reshape/flatten/clip/T``),
``backward(grad)`` and ``zero_grad()`` all match the reference contract
(reference: core/tensor.py:48-171).
"""

import jax.numpy as jnp
import numpy as np


def as_tensor(obj):
    """Coerce ``obj`` to a Tensor (reference: core/tensor.py:7-10)."""
    if not isinstance(obj, Tensor):
        obj = Tensor(obj)
    return obj


def _grad_dtype(dtype):
    """Gradients are float even for integer-valued tensors."""
    if jnp.issubdtype(dtype, jnp.inexact):
        return dtype
    return jnp.float32


class Tensor:
    """Array + autodiff tape node.

    ``dependency`` is a list of ``{"tensor": parent, "grad_fn": vjp}`` records
    (reference: core/ops.py:12-29); ``grad_fn`` maps this tensor's cotangent to
    the parent's cotangent, honoring numpy broadcasting semantics.
    """

    def __init__(self, values, requires_grad=False, dependency=None, dtype=None):
        self._values = jnp.asarray(values, dtype=dtype)

        self.grad = None
        self.requires_grad = requires_grad
        if self.requires_grad:
            self.zero_grad()

        if dependency is None:
            dependency = []
        # normalize to (tensor, grad_fn) tuples internally
        self._deps = [
            (d["tensor"], d["grad_fn"]) if isinstance(d, dict) else tuple(d)
            for d in dependency
        ]

    # ------------------------------------------------------------------ data

    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, new_values):
        self._values = jnp.asarray(new_values)
        self.grad = None

    # ``data`` is an alias used throughout the op layer.
    @property
    def data(self):
        return self._values

    @property
    def dependency(self):
        return [{"tensor": t, "grad_fn": f} for t, f in self._deps]

    @dependency.setter
    def dependency(self, deps):
        self._deps = [
            (d["tensor"], d["grad_fn"]) if isinstance(d, dict) else tuple(d)
            for d in (deps or [])
        ]

    @property
    def shape(self):
        return self._values.shape

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def ndim(self):
        return self._values.ndim

    @property
    def size(self):
        return self._values.size

    def numpy(self):
        """Materialize to host numpy (blocks on the device value)."""
        return np.asarray(self._values)

    def __array__(self, dtype=None):
        """numpy protocol: np.argmax(tensor), np.asarray(tensor), ... work
        directly (the reference relies on numpy's sequence fallback for
        this, reference: examples/mnist/run.py:89)."""
        return np.asarray(self._values, dtype)

    def item(self):
        return self._values.item()

    def tolist(self):
        return np.asarray(self._values).tolist()

    def detach(self):
        """A view of the same data with no tape history."""
        return Tensor(self._values)

    def astype(self, dtype):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.astype_(self, dtype)

    def __repr__(self):
        return "Tensor(shape=%s, requires_grad=%s)" % (self.shape, self.requires_grad)

    def __len__(self):
        return len(self._values)

    # ----------------------------------------------------- comparisons (raw)

    def __gt__(self, other):
        return self._values > as_tensor(other)._values

    def __lt__(self, other):
        return self._values < as_tensor(other)._values

    def __ge__(self, other):
        return self._values >= as_tensor(other)._values

    def __le__(self, other):
        return self._values <= as_tensor(other)._values

    # ------------------------------------------------------------ arithmetic

    def __add__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.add_(self, as_tensor(other))

    def __radd__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.add_(as_tensor(other), self)

    def __iadd__(self, other):
        self.values = self._values + as_tensor(other)._values
        return self

    def __sub__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.sub_(self, as_tensor(other))

    def __rsub__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.sub_(as_tensor(other), self)

    def __isub__(self, other):
        self.values = self._values - as_tensor(other)._values
        return self

    def __mul__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.mul_(self, as_tensor(other))

    def __rmul__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.mul_(as_tensor(other), self)

    def __imul__(self, other):
        self.values = self._values * as_tensor(other)._values
        return self

    def __truediv__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.div_(self, as_tensor(other))

    def __rtruediv__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.div_(as_tensor(other), self)

    def __itruediv__(self, other):
        self.values = self._values / as_tensor(other)._values
        return self

    def __neg__(self):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.neg_(self)

    def __getitem__(self, key):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.getitem_(self, key)

    def __pow__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.pow_(self, as_tensor(other))

    def __rpow__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.pow_(as_tensor(other), self)

    def __ipow__(self, other):
        self.values = self._values ** as_tensor(other)._values
        return self

    def __matmul__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.dot_(self, as_tensor(other))

    def __rmatmul__(self, other):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.dot_(as_tensor(other), self)

    def __imatmul__(self, other):
        self.values = self._values @ as_tensor(other)._values
        return self

    # ------------------------------------------------------------ method ops

    def sum(self, axis=None, keepdims=False):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.sum_(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.mean_(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.max_(self, axis=axis)

    def min(self, axis=None):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.min_(self, axis=axis)

    def transpose(self, axes=None):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.transpose_(self, axes=axes)

    def log(self):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.log_(self)

    def exp(self):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.exp_(self)

    def reshape(self, newshape):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.reshape_(self, newshape)

    def flatten(self):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.flatten_(self)

    def clip(self, min=None, max=None):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.clip_(self, min, max)

    @property
    def T(self):
        from tinynn_autograd_tpu.ops import primitives as _ops

        return _ops.transpose_(self, axes=None)

    # -------------------------------------------------------------- autodiff

    def backward(self, grad=None):
        """Reverse-mode gradient propagation.

        Seeds this tensor's cotangent with ``grad`` (default: ones), walks the
        tape once in reverse topological order, and *accumulates* into the
        ``.grad`` of every reachable ``requires_grad`` tensor — same observable
        contract as the reference (reference: core/tensor.py:157-168) but with
        one visit per node instead of one visit per path.

        Works both eagerly and while being traced by ``jax.jit``: under a
        trace, the tape is a static Python structure and the gradient flow
        becomes part of the single staged XLA program.
        """
        assert self.requires_grad, "Call backward() on a non-requires-grad tensor."
        gdtype = _grad_dtype(self.dtype)
        if grad is None:
            seed = jnp.ones(self.shape, dtype=gdtype)
        else:
            if isinstance(grad, Tensor):
                grad = grad.data  # unwrap (works on traced payloads too)
            seed = jnp.broadcast_to(
                jnp.asarray(grad).astype(gdtype), self.shape)

        order = _topo_order(self)
        cotangents = {id(self): seed}
        for t in order:
            g = cotangents.pop(id(t), None)
            if g is None:
                continue
            t.grad = g if t.grad is None else t.grad + g
            for parent, grad_fn in t._deps:
                pg = grad_fn(g)
                prev = cotangents.get(id(parent))
                cotangents[id(parent)] = pg if prev is None else prev + pg

    def zero_grad(self):
        self.grad = jnp.zeros(self.shape, dtype=_grad_dtype(self.dtype))


def _topo_order(root):
    """Iterative post-order DFS over the tape; returns dependents-first order.

    The returned list starts at ``root`` and ends at the leaves: position i
    always precedes every tensor reachable from it, so a single forward pass
    over the list propagates cotangents correctly.
    """
    order = []
    visited = set()
    # stack of (tensor, child_iterator)
    stack = [(root, iter(root._deps))]
    visited.add(id(root))
    while stack:
        node, it = stack[-1]
        advanced = False
        for parent, _ in it:
            if id(parent) not in visited:
                visited.add(id(parent))
                stack.append((parent, iter(parent._deps)))
                advanced = True
                break
        if not advanced:
            order.append(node)
            stack.pop()
    order.reverse()
    return order
