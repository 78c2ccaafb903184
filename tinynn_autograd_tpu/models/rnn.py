"""Recurrent model family (LSTM/GRU sequence classifiers/regressors).

The reference has no recurrent models (its only family is the MLP,
reference examples/mnist/run.py:59-69); this is an addition on
the single-scan BPTT primitives in ops/recurrent.py — each recurrent
layer compiles to exactly two scan kernels (forward + reverse BPTT)
regardless of sequence length or stack depth.
"""

from tinynn_autograd_tpu.nn.layers import LSTM, GRU, Dense
from tinynn_autograd_tpu.nn.net import Net

_CELLS = {"lstm": LSTM, "gru": GRU}


def build_rnn_classifier(num_in, num_out, hidden=(64,), cell="lstm",
                         seed=None):
    """Stacked recurrent classifier over [B, T, num_in] -> [B, num_out]
    logits. All but the last recurrent layer return full sequences (so
    stacking composes); the last returns its final hidden state, followed
    by a Dense head. ``cell`` is "lstm" or "gru"."""
    cell_cls = _CELLS[cell]
    layers = []
    prev = num_in
    for i, h in enumerate(hidden):
        last = i == len(hidden) - 1
        layers.append(cell_cls(
            h, num_in=prev, return_sequences=not last,
            seed=None if seed is None else seed + i))
        prev = h
    layers.append(Dense(num_out, num_in=prev,
                        seed=None if seed is None else seed + len(hidden)))
    return Net(layers)
