"""Net: ordered layer container (reference surface: core/nn.py).

Beyond the reference's forward/get/set_parameters/set_phase, Net supports the
fused-jit path: ``init(input_shape)`` materializes all lazy parameters by
static shape inference (no compute, no tracing hazards), ``params_tree`` /
``bind_params`` convert between the stateful layer view and the raw-array
pytree that flows through the jitted train step.
"""

import jax

from tinynn_autograd_tpu.core.tensor import Tensor, as_tensor


class Net:

    def __init__(self, layers):
        self.layers = layers
        self._phase = "TRAIN"

    def forward(self, inputs, rng=None):
        """Chain layer forwards (reference: core/nn.py:10-13). ``rng``, if
        given, is split across the layers that consume randomness (dropout)
        so masks are fresh per call/step even under jit."""
        inputs = as_tensor(inputs)
        if rng is not None:
            rng_layers = [l for l in self.layers if hasattr(l, "set_rng")]
            if rng_layers:
                keys = jax.random.split(rng, len(rng_layers))
                for layer, key in zip(rng_layers, keys):
                    layer.set_rng(key)
        for layer in self.layers:
            inputs = layer.forward(inputs)
        return inputs

    def init(self, input_shape):
        """Materialize every lazy parameter by propagating static shapes
        through the stack. Returns the output shape."""
        shape = tuple(input_shape)
        for layer in self.layers:
            init_fn = getattr(layer, "init_params", None)
            if init_fn is not None:
                shape = tuple(init_fn(shape))
        return shape

    @property
    def is_init(self):
        return all(layer.is_init for layer in self.layers)

    def get_parameters(self):
        return [layer.params for layer in self.layers]

    def set_parameters(self, params):
        """Key/shape-checked parameter load (reference: core/nn.py:18-23);
        accepts Tensors or raw arrays."""
        for i, layer in enumerate(self.layers):
            assert layer.params.keys() == params[i].keys(), (
                layer.name, list(layer.params), list(params[i]))
            for key in layer.params.keys():
                new = params[i][key]
                if not isinstance(new, Tensor):
                    new = Tensor(new, requires_grad=True)
                if layer.params[key] is not None:
                    assert tuple(layer.params[key].shape) == tuple(new.shape), (
                        layer.name, key, layer.params[key].shape, new.shape)
                layer.params[key] = new

    # -------------------------------------------------- fused-jit plumbing

    def params_tree(self):
        """Raw-array pytree (list of per-layer dicts) of current params."""
        return [
            {k: v.data for k, v in layer.params.items() if v is not None}
            for layer in self.layers
        ]

    def bind_params(self, tree):
        """Install a (possibly traced) raw-array pytree as the layers' live
        parameters, wrapped as requires_grad leaf Tensors. Called inside the
        jitted step at trace time; the resulting Tensors carry the tape."""
        for layer, layer_tree in zip(self.layers, tree):
            for k, arr in layer_tree.items():
                layer.params[k] = Tensor(arr, requires_grad=True)

    def collect_grads(self):
        """Gradient pytree congruent with ``params_tree`` (post-backward)."""
        return [
            {k: v.grad for k, v in layer.params.items() if v is not None}
            for layer in self.layers
        ]

    def buffers_tree(self):
        """Raw-array pytree of non-trainable layer state (e.g. BatchNorm
        running stats): list of per-layer dicts, {} for stateless layers."""
        return [
            {k: v for k, v in getattr(layer, "buffers", {}).items()
             if v is not None}
            for layer in self.layers
        ]

    def collect_buffer_updates(self):
        """Post-forward buffers pytree, congruent with ``buffers_tree``:
        layers that produced new (possibly traced) buffer values during the
        forward (e.g. BatchNorm's running-stat EMA, stashed in
        ``_new_buffers``) contribute those; stateless layers pass their
        bound buffers through. Called inside the fused step so buffer
        updates become outputs of the jitted program."""
        out = []
        for layer, buf in zip(self.layers, self.buffers_tree()):
            buf.update(getattr(layer, "_new_buffers", None) or {})
            out.append(buf)
        return out

    def bind_buffers(self, tree):
        """Install a (possibly traced) buffers pytree as the layers' live
        non-trainable state. Jitted inference passes buffers as ARGUMENTS
        and binds them at trace time, so running statistics are never baked
        into a cached executable as stale constants."""
        for layer, layer_tree in zip(self.layers, tree):
            for k, arr in layer_tree.items():
                layer.buffers[k] = arr

    # --------------------------------------------------------------- phase

    def get_phase(self):
        return self._phase

    def set_phase(self, phase):
        for layer in self.layers:
            layer.set_phase(phase)
        self._phase = phase
