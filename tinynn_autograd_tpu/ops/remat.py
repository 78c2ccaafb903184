"""Tape-level activation rematerialization (gradient checkpointing).

The analog of ``jax.checkpoint`` for the tape autodiff: the
forward runs the wrapped subgraph once but DISCARDS its tape — and with
it every intermediate activation — keeping only the output values; the
backward re-runs the subgraph from its inputs and walks the fresh inner
tape to produce cotangents. One extra forward pass buys O(depth)
activation memory, the standard lever where device memory (not FLOPs)
binds first for deep stacks and long contexts.

The reference has no counterpart: its tape (reference core/ops.py:12-29)
unconditionally closes every intermediate into the stored ``grad_fn``
closures, so activation memory always scales with graph size.

Two correctness hazards, both handled here:

- **CSE**: under ``jit`` the forward and the recompute are structurally
  identical subgraphs, and XLA's common-subexpression elimination would
  happily fold them back together — silently undoing the memory saving.
  The recompute therefore reads its inputs through
  ``lax.optimization_barrier`` (the same mechanism ``jax.checkpoint``
  uses), which XLA is forbidden to look through.
- **Randomness**: the recompute must REPLAY the forward's stochastic
  draws (dropout masks) exactly, or gradients are silently wrong. That
  discipline lives in the caller (``nn.layers.Remat`` snapshots the rng
  and re-injects it for both passes); ``remat_`` itself just runs ``fn``
  twice and requires it to be deterministic between the two runs.

Gradients for Tensors *closed over* by ``fn`` (layer parameters) are
accumulated as a side effect of the inner backward during the recompute
— exactly once per outer backward, because the outer tape walk visits
each node once with its fully-summed cotangent (core/tensor.py:335-345).
"""

from jax import lax

from tinynn_autograd_tpu.core.tensor import Tensor, as_tensor


def remat_(fn, *inputs):
    """Run ``fn(*inputs)`` without retaining its tape; recompute on
    backward.

    ``fn`` takes and returns a single-output ``Tensor`` computation over
    its positional Tensor arguments (it may close over parameter
    Tensors, whose ``.grad`` is accumulated during the recompute). It
    must be deterministic across the two invocations — thread rng
    explicitly (see ``nn.layers.Remat``).
    """
    ins = [as_tensor(t) for t in inputs]
    out = fn(*[Tensor(t.data) for t in ins])  # inner tape dies here
    if not isinstance(out, Tensor):
        raise TypeError("remat_ expects fn to return a single Tensor, "
                        "got %r" % type(out))
    # ``out.requires_grad`` (from the probe run) also catches the common
    # case where only CLOSED-OVER tensors (layer params) are trainable
    if not (any(t.requires_grad for t in ins) or out.requires_grad):
        # sever history: remat's contract is that no inner intermediate
        # outlives the forward
        return Tensor(out.data)

    dep_idx = [i for i, t in enumerate(ins) if t.requires_grad]
    if not dep_idx:
        # no differentiable explicit input, but params need their grads:
        # hang the recompute off input 0 (the tape walk invokes grad_fns
        # of non-requires-grad parents too, core/tensor.py:342-345)
        dep_idx = [0]
    # The outer walk calls each dep's grad_fn exactly once per backward,
    # all with the SAME cotangent object — recompute once, hand out the
    # per-input grads, then drop the cache so nothing stays live.
    state = {"g": None, "grads": None, "left": 0}

    def _recompute(g):
        if state["g"] is not g:
            barriered = lax.optimization_barrier(
                tuple(t.data for t in ins))
            re_in = [Tensor(v, requires_grad=True) for v in barriered]
            re_out = fn(*re_in)
            re_out.backward(g)
            state["g"] = g
            state["grads"] = [re_in[i].grad for i in dep_idx]
            state["left"] = len(dep_idx)
        return state["grads"]

    def _make_grad_fn(slot):
        def grad_fn(g):
            pg = _recompute(g)[slot]
            state["left"] -= 1
            if state["left"] == 0:
                state["g"], state["grads"] = None, None
            return pg
        return grad_fn

    deps = [{"tensor": ins[i], "grad_fn": _make_grad_fn(slot)}
            for slot, i in enumerate(dep_idx)]
    return Tensor(out.data, requires_grad=True, dependency=deps)
