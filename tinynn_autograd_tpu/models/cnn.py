"""MNIST CNN (benchmark config #4): Conv2D + MaxPool, both conv directions
single XLA convolutions. NHWC layout throughout. The reference has no
conv layer (its run.py docstring mentions a CNN that never existed — see
SURVEY.md §2.3)."""

from tinynn_autograd_tpu.nn.layers import (
    Conv2D, Dense, Flatten, MaxPool2D, ReLU,
)
from tinynn_autograd_tpu.nn.net import Net


def build_mnist_cnn(num_classes=10):
    """28x28x1 -> conv3x3(16) -> pool2 -> conv3x3(32) -> pool2 -> dense."""
    return Net([
        Conv2D(kernel=(3, 3, 1, 16), stride=1, padding="SAME"),
        ReLU(),
        MaxPool2D(pool_size=2),
        Conv2D(kernel=(3, 3, 16, 32), stride=1, padding="SAME"),
        ReLU(),
        MaxPool2D(pool_size=2),
        Flatten(),
        Dense(128),
        ReLU(),
        Dense(num_classes),
    ])
