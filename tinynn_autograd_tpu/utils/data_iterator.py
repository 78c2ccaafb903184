"""Batch iteration (reference surface: utils/data_iterator.py).

``BatchIterator`` shuffles with a host-side numpy permutation (cheap, and
keeps the device free) and yields ``Batch(inputs, targets)`` namedtuples
(reference contract: utils/data_iterator.py:7-34).

Addition: ``drop_last`` — under jit, every distinct batch shape compiles
a separate XLA program, so dropping the ragged final batch keeps the whole
epoch on ONE compiled train step. Default False for reference parity.
"""

from collections import namedtuple

import numpy as np

Batch = namedtuple("Batch", ["inputs", "targets"])


class BaseIterator:

    def __call__(self, inputs, targets):
        raise NotImplementedError


class BatchIterator(BaseIterator):

    def __init__(self, batch_size=32, shuffle=True, drop_last=False):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __call__(self, inputs, targets):
        from tinynn_autograd_tpu import native

        n = len(inputs)
        if self.shuffle:
            perm = np.random.permutation(n)
        else:
            perm = None

        def take(arr, idx):
            # native multithreaded row gather for contiguous f32 host arrays
            if isinstance(arr, np.ndarray):
                return native.gather_rows(arr, idx)
            return arr[idx]

        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            if self.drop_last and start + self.batch_size > n:
                break
            if perm is not None:
                idx = perm[start:start + self.batch_size]
                batch_inputs = take(inputs, idx)
                batch_targets = take(targets, idx)
            else:
                end = start + self.batch_size
                batch_inputs = inputs[start:end]
                batch_targets = targets[start:end]
            yield Batch(inputs=batch_inputs, targets=batch_targets)


class PrefetchIterator(BaseIterator):
    """Wrap any BaseIterator with a background thread that prepares batches
    ahead of the consumer (host-side gather/one-hot overlaps device compute
    in eager training loops). ``depth`` batches are buffered in a queue.

    No reference counterpart (the reference prepares every batch inline on
    the hot path, utils/data_iterator.py:22-34 there). The one-dispatch
    paths don't need this — data is staged to device memory once — but the
    reference-style per-batch loop benefits on slow hosts.
    """

    _DONE = object()

    def __init__(self, iterator=None, depth=2, **batch_kwargs):
        self.iterator = iterator if iterator is not None else BatchIterator(
            **batch_kwargs)
        self.depth = depth

    def __call__(self, inputs, targets):
        import queue
        import threading

        q = queue.Queue(maxsize=self.depth)
        err = []
        stop = threading.Event()

        def put(item):
            # bounded-wait put so an abandoned consumer (early break /
            # GeneratorExit) can't strand the worker on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.iterator(inputs, targets):
                    if not put(batch):
                        return
            except BaseException as e:  # surface in the consumer thread
                err.append(e)
            finally:
                put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5)
            if err:
                raise err[0]
