"""Autograd op contract: port of the reference value/grad assertions
(reference: test/test_autograd.py) against the tape engine,
plus regression tests for reference bugs we fixed (non-leading-axis reduce
VJPs, scatter-add getitem) and for the single-visit tape walk."""

import numpy as np
import pytest

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu import Tensor


def test_add_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = Tensor([5, -2, -9], requires_grad=True)
    t3 = t1 + t2
    assert t3.values.tolist() == [6, 1, -4]
    t3.backward([2, 2, 2])
    assert t1.grad.tolist() == [2, 2, 2]
    assert t2.grad.tolist() == [2, 2, 2]

    # broadcast (2, 3) + (3,) -> (2, 3)
    t1 = Tensor([[1, 3, 5], [2, 3, 0]], requires_grad=True)
    t2 = Tensor([5, -2, -9], requires_grad=True)
    t3 = t1 + t2
    assert t3.values.tolist() == [[6, 1, -4], [7, 1, -9]]
    t3.backward([[1, 1, 1], [2, 2, 2]])
    assert t1.grad.tolist() == [[1, 1, 1], [2, 2, 2]]
    assert t2.grad.tolist() == [3, 3, 3]

    # broadcast (2, 3) + (1, 3) -> (2, 3)
    t1 = Tensor([[1, 3, 5], [2, 3, 0]], requires_grad=True)
    t2 = Tensor([[5, -2, -9]], requires_grad=True)
    t3 = t1 + t2
    assert t3.values.tolist() == [[6, 1, -4], [7, 1, -9]]
    t3.backward([[1, 1, 1], [2, 2, 2]])
    assert t1.grad.tolist() == [[1, 1, 1], [2, 2, 2]]
    assert t2.grad.tolist() == [[3, 3, 3]]


def test_sub_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = Tensor([5, -2, -9], requires_grad=True)
    t3 = t1 - t2
    assert t3.values.tolist() == [-4, 5, 14]
    t3.backward([1, 2, 3])
    assert t1.grad.tolist() == [1, 2, 3]
    assert t2.grad.tolist() == [-1, -2, -3]


def test_mul_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = Tensor([5, -2, -9], requires_grad=True)
    t3 = t1 * t2
    assert t3.values.tolist() == [5, -6, -45]
    t3.backward([2, 2, 2])
    assert t1.grad.tolist() == [10, -4, -18]
    assert t2.grad.tolist() == [2, 6, 10]


def test_div_op():
    t1 = Tensor([1.0, 2.0, 5.0], requires_grad=True)
    t2 = Tensor([8.0, -2.0, -10.0], requires_grad=True)
    t3 = t1 / t2
    assert t3.values.tolist() == [0.125, -1, -0.5]
    t3.backward([1, 1, 1])
    np.testing.assert_allclose(t1.grad, [0.125, -0.5, -0.1], rtol=1e-6)
    np.testing.assert_allclose(t2.grad, [-0.015625, -0.5, -0.05], rtol=1e-6)


def test_pow_op():
    t1 = Tensor([1.0, -3.0, 5.0], requires_grad=True)
    t2 = t1 ** 3
    assert t2.values.tolist() == [1, -27, 125]
    t2.backward([2, 2, 2])
    np.testing.assert_allclose(t1.grad, [6.0, 54.0, 150.0], rtol=1e-6)


def test_dot_op():
    t1 = Tensor([[1, 3, 5], [5, -2, 9]], requires_grad=True)
    t2 = Tensor([[9, 8, 9, 7], [4, 0, 3, 0], [0, 8, 2, 7]], requires_grad=True)
    t3 = t1 @ t2
    assert t3.values.tolist() == [[21, 48, 28, 42], [37, 112, 57, 98]]
    t3.backward([[1, 2, 3, 4], [4, 3, 2, 1]])
    assert t1.grad.tolist() == [[80, 13, 50], [85, 22, 35]]
    assert t2.grad.tolist() == [[21, 17, 13, 9], [-5, 0, 5, 10], [41, 37, 33, 29]]


def test_dot_op_vector_cases():
    # 1-D @ 1-D
    a = Tensor([1.0, 2.0, 3.0], requires_grad=True)
    b = Tensor([4.0, 5.0, 6.0], requires_grad=True)
    c = a @ b
    assert c.values.tolist() == 32.0
    c.backward()
    assert a.grad.tolist() == [4, 5, 6]
    assert b.grad.tolist() == [1, 2, 3]

    # 2-D @ 1-D
    m = Tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    v = Tensor([5.0, 6.0], requires_grad=True)
    y = m @ v
    assert y.values.tolist() == [17.0, 39.0]
    y.backward([1.0, 1.0])
    assert m.grad.tolist() == [[5, 6], [5, 6]]
    assert v.grad.tolist() == [4, 6]

    # 1-D @ 2-D
    vv = Tensor([5.0, 6.0], requires_grad=True)
    mm = Tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    y3 = vv @ mm
    assert y3.values.tolist() == [23.0, 34.0]
    y3.backward([1.0, 1.0])
    assert vv.grad.tolist() == [3, 7]
    assert mm.grad.tolist() == [[5, 5], [6, 6]]


def test_dot_op_batched():
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3, 5).astype(np.float32)
    b = rng.randn(5, 2).astype(np.float32)  # broadcast over batch
    ta = Tensor(a, requires_grad=True)
    tb = Tensor(b, requires_grad=True)
    out = ta @ tb
    np.testing.assert_allclose(out.values, a @ b, rtol=1e-5)
    g = rng.randn(4, 3, 2).astype(np.float32)
    out.backward(g)
    np.testing.assert_allclose(ta.grad, g @ b.T, rtol=1e-5)
    np.testing.assert_allclose(
        tb.grad, np.einsum("bmk,bmn->kn", a, g), rtol=1e-4
    )


def test_sum_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = Tensor([5, -2, -9], requires_grad=True)
    t3 = (t1 + t2).sum()
    assert t3.values == 3
    t3.backward(2)
    assert t1.grad.tolist() == [2, 2, 2]
    assert t2.grad.tolist() == [2, 2, 2]


def test_sum_axis_and_tuple():
    x = Tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    s1 = x.sum(axis=1)
    assert s1.values.tolist() == [3.0, 7.0]
    s1.backward([1.0, 2.0])
    assert x.grad.tolist() == [[1, 1], [2, 2]]

    x.zero_grad()
    s2 = ops.sum(x, axis=(0, 1))
    assert s2.values.tolist() == 10.0
    s2.backward()
    assert x.grad.tolist() == [[1, 1], [1, 1]]

    x.zero_grad()
    s3 = ops.sum(x, axis=0, keepdims=True)
    assert s3.values.tolist() == [[4.0, 6.0]]
    s3.backward([[1.0, 3.0]])
    assert x.grad.tolist() == [[1, 3], [1, 3]]


def test_exp_op():
    t1 = Tensor([1.0, 3.0, 5.0], requires_grad=True)
    t2 = ops.exp(t1)
    np.testing.assert_allclose(t2.values, np.exp([1.0, 3.0, 5.0]), rtol=1e-6)
    t2.backward([1, 2, 3])
    np.testing.assert_allclose(
        t1.grad, np.exp([1.0, 3.0, 5.0]) * np.array([1, 2, 3]), rtol=1e-6
    )


def test_neg_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = -t1
    assert t2.values.tolist() == [-1, -3, -5]
    t2.backward([1, 2, 3])
    assert t1.grad.tolist() == [-1, -2, -3]


def test_maximum_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = Tensor([5, -2, 9], requires_grad=True)
    t3 = ops.maximum_(t1, t2)
    assert t3.values.tolist() == [5, 3, 9]
    t3.backward([1, 2, 1])
    assert t1.grad.tolist() == [0, 2, 0]
    assert t2.grad.tolist() == [1, 0, 1]


def test_maximum_tie_goes_to_first():
    t1 = Tensor([2.0, 7.0], requires_grad=True)
    t2 = Tensor([2.0, 1.0], requires_grad=True)
    t3 = ops.maximum_(t1, t2)
    t3.backward([1.0, 1.0])
    assert t1.grad.tolist() == [1, 1]
    assert t2.grad.tolist() == [0, 0]


def test_minimum_op():
    t1 = Tensor([1, 3, 5], requires_grad=True)
    t2 = Tensor([5, -2, 9], requires_grad=True)
    t3 = ops.minimum_(t1, t2)
    assert t3.values.tolist() == [1, -2, 5]
    t3.backward([1, 2, 1])
    assert t1.grad.tolist() == [1, 0, 1]
    assert t2.grad.tolist() == [0, 2, 0]


def test_transpose_op():
    shape = [2, 4, 6]
    data = np.random.randn(*shape)
    t1 = Tensor(data, requires_grad=True)
    t2 = t1.T
    assert list(t2.shape) == shape[::-1]
    t2.backward(np.ones_like(np.asarray(t2.values)))
    assert list(t1.grad.shape) == shape

    t2 = t1.transpose((2, 0, 1))
    assert list(t2.shape) == [6, 2, 4]
    t2.backward(np.ones((6, 2, 4)))
    assert list(t1.grad.shape) == shape


def test_max_op():
    t1 = Tensor([[1, 3, 5], [3, 7, -2]], requires_grad=True)
    t2 = ops.max(t1, axis=None)
    t3 = ops.max(t1, axis=0)
    assert t2.values == 7
    assert t3.values.tolist() == [3, 7, 5]

    t2.backward()
    assert t1.grad.tolist() == [[0, 0, 0], [0, 1, 0]]
    t1.zero_grad()
    t3.backward([1, 1, 1])
    assert t1.grad.tolist() == [[0, 0, 1], [1, 1, 0]]


def test_max_op_nonleading_axis():
    # the reference's VJP raises for axis=1 on 2-D (reference core/ops.py:229);
    # ours must be correct for any axis.
    t1 = Tensor([[1.0, 3.0, 5.0], [3.0, 7.0, -2.0]], requires_grad=True)
    t2 = ops.max(t1, axis=1)
    assert t2.values.tolist() == [5.0, 7.0]
    t2.backward([1.0, 2.0])
    assert t1.grad.tolist() == [[0, 0, 1], [0, 2, 0]]


def test_max_op_tie_full_grad_each():
    t1 = Tensor([[2.0, 2.0]], requires_grad=True)
    t2 = ops.max(t1, axis=1)
    t2.backward([3.0])
    # ties receive the FULL gradient each (reference semantics)
    assert t1.grad.tolist() == [[3, 3]]


def test_min_op():
    t1 = Tensor([[1.0, 3.0, 5.0], [3.0, 7.0, -2.0]], requires_grad=True)
    t2 = ops.min(t1, axis=1)
    assert t2.values.tolist() == [1.0, -2.0]
    t2.backward([1.0, 2.0])
    assert t1.grad.tolist() == [[1, 0, 0], [0, 0, 2]]


def test_log_op():
    t1 = Tensor([1.0, 3.0, 5.0], requires_grad=True)
    t2 = ops.log(t1)
    np.testing.assert_allclose(t2.values, np.log([1.0, 3.0, 5.0]), rtol=1e-6)
    grad = np.array([1.0, 2.0, 3.0])
    t2.backward(grad)
    np.testing.assert_allclose(t1.grad, grad / np.array([1.0, 3.0, 5.0]), rtol=1e-6)


def test_reshape_op():
    t1 = Tensor([[1, 2, 3], [4, 5, 6]], requires_grad=True)
    t2 = ops.reshape(t1, (6,))
    assert t2.values.tolist() == [1, 2, 3, 4, 5, 6]
    t2.backward(np.ones(6))
    assert t1.grad.tolist() == [[1, 1, 1], [1, 1, 1]]


def test_pad_op():
    t1 = Tensor([[1, 2, 3], [4, 5, 6]], requires_grad=True)
    pad_width = [(1, 0), (1, 0)]
    t2 = ops.pad(t1, pad_width)
    assert t2.values.tolist() == [[0, 0, 0, 0], [0, 1, 2, 3], [0, 4, 5, 6]]
    t2.backward(np.ones((3, 4)))
    assert t1.grad.shape == t1.shape
    assert t1.grad.tolist() == [[1, 1, 1], [1, 1, 1]]


def test_pad_noncostant_mode_refuses_grad():
    t1 = Tensor([[1.0, 2.0]], requires_grad=True)
    with pytest.raises(ValueError):
        ops.pad(t1, [(0, 0), (1, 1)], mode="edge")
    # but forward-only works on a non-grad tensor
    t2 = ops.pad(Tensor([[1.0, 2.0]]), [(0, 0), (1, 1)], mode="edge")
    assert t2.values.tolist() == [[1, 1, 2, 2]]


def test_flatten_op():
    t1 = Tensor([[1, 2, 3], [4, 5, 6]], requires_grad=True)
    t2 = ops.flatten(t1)
    assert t2.values.tolist() == [1, 2, 3, 4, 5, 6]
    t2.backward(np.ones(6))
    assert t1.grad.shape == t1.shape
    assert t1.grad.tolist() == [[1, 1, 1], [1, 1, 1]]


def test_clip_op():
    t1 = Tensor([1, -3, 5], requires_grad=True)
    t2 = ops.clip(t1, 0)
    assert t2.values.tolist() == [1, 0, 5]
    grad = np.array([1, 2, 3])
    t2.backward(grad)
    assert t1.grad.tolist() == [1, 0, 3]


def test_clip_boundary_inclusive():
    t1 = Tensor([0.0, 1.0, 2.0], requires_grad=True)
    t2 = ops.clip(t1, 0.0, 1.0)
    t2.backward([1.0, 1.0, 1.0])
    # boundary values pass gradient through (reference core/ops.py:336-343)
    assert t1.grad.tolist() == [1, 1, 0]


def test_getitem_op():
    t1 = Tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], requires_grad=True)
    t2 = t1[0]
    assert t2.values.tolist() == [1, 2, 3]
    t2.backward([1.0, 2.0, 3.0])
    assert t1.grad.tolist() == [[1, 2, 3], [0, 0, 0]]

    t1.zero_grad()
    t3 = t1[:, 1]
    assert t3.values.tolist() == [2, 5]
    t3.backward([1.0, 1.0])
    assert t1.grad.tolist() == [[0, 1, 0], [0, 1, 0]]


def test_getitem_repeated_indices_accumulate():
    # deliberate divergence from the reference (last-write-wins,
    # reference core/ops.py:285-288): scatter-ADD is the correct adjoint.
    t1 = Tensor([1.0, 2.0, 3.0], requires_grad=True)
    idx = np.array([0, 0, 2])
    t2 = t1[idx]
    assert t2.values.tolist() == [1, 1, 3]
    t2.backward([1.0, 1.0, 1.0])
    assert t1.grad.tolist() == [2, 0, 1]


def test_minimal_nn():
    np.random.seed(0)
    x = Tensor(np.random.normal(0, 1.0, (100, 3)).astype(np.float32))
    y = x * 3.14 + 30

    w1 = Tensor(np.random.normal(0, 1.0, (3, 3)).astype(np.float32), requires_grad=True)
    b1 = Tensor(np.random.normal(0, 1.0, 3).astype(np.float32), requires_grad=True)

    previous_loss = 1e10
    for _ in range(100):
        w1.zero_grad()
        b1.zero_grad()
        predicted = x @ w1 + b1
        err = predicted - y
        loss = (err ** 2).sum()
        loss.backward()
        w1 -= 0.001 * w1.grad
        b1 -= 0.001 * b1.grad
        assert loss.values < previous_loss
        previous_loss = loss.values


def test_shared_subexpression_diamond():
    # d/dx of (x*x + x*x) = 4x; the tape must produce correct totals on a
    # diamond graph AND visit each node exactly once (the reference recursion
    # is path-exponential, reference core/tensor.py:157-168).
    x = Tensor(2.0, requires_grad=True)
    y = x * x
    z = y + y
    z.backward()
    assert float(x.grad) == 8.0


def test_tape_single_visit_per_node():
    calls = {"n": 0}
    x = Tensor(1.0, requires_grad=True)
    t = x
    # deep chain with sharing: each level t = t + t
    for _ in range(30):
        t = t + t

    # wrap the final add's grad_fns to count invocations via dependency rebuild
    deps = t.dependency
    for d in deps:
        orig = d["grad_fn"]

        def counted(g, orig=orig):
            calls["n"] += 1
            return orig(g)

        d["grad_fn"] = counted
    t.dependency = deps

    t.backward()
    # 2^30 paths through the graph; recursion would invoke grad_fns ~2^30
    # times. Topological walk: each of the two edges of the last node once.
    assert calls["n"] == 2
    assert float(x.grad) == 2.0 ** 30


def test_backward_accumulates_across_calls():
    x = Tensor([1.0, 2.0], requires_grad=True)
    y = x * 3.0
    y.backward([1.0, 1.0])
    assert x.grad.tolist() == [3, 3]
    y2 = x * 2.0
    y2.backward([1.0, 1.0])
    # grads accumulate until zero_grad (reference core/tensor.py:163)
    assert x.grad.tolist() == [5, 5]
    x.zero_grad()
    assert x.grad.tolist() == [0, 0]


def test_requires_grad_propagation():
    a = Tensor([1.0], requires_grad=True)
    b = Tensor([2.0])  # data tensor, no grad
    c = a * b
    assert c.requires_grad
    assert len(c.dependency) == 1
    c.backward([1.0])
    assert a.grad.tolist() == [2]
    assert b.grad is None

    d = Tensor([1.0]) + Tensor([2.0])
    assert not d.requires_grad
    assert d.dependency == []


def test_inplace_ops_bypass_autograd():
    w = Tensor([1.0, 2.0], requires_grad=True)
    w.zero_grad()
    w += np.array([1.0, 1.0])
    assert w.values.tolist() == [2, 3]
    assert w.grad is None  # values setter nulls grad (reference tensor.py:35-38)
