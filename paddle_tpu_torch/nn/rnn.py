"""Recurrent layers — twin of ``paddle_tpu/nn/rnn.py``: the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the wrappers ``RNN`` and
``BiRNN``, and the stacked ``SimpleRNN``, ``GRU`` and ``LSTM``.

Parameter names, shapes (``[gates·H, in]``, used as ``x @ Wᵀ``) and gate
orders are the JAX package's: LSTM ``[i, f, g, o]``; GRU ``[r, z, c]``,
the reset gate multiplying the hidden product that already holds
``b_hh``.  Layout: ``time_major=False`` is ``[batch, time, size]``.

Where the JAX package runs a stacked layer's direction as one
``lax.scan`` inside one dispatched op, the port runs one dispatched op
whose body is a Python loop over the time steps (torch autograd records
the graph); the per-step cells dispatch once a step, as in the JAX
package.  ``sequence_length``, which the JAX package accepts and
ignores, raises here (ROADMAP queue 1 item 8)."""
from __future__ import annotations

import math

import torch

from ..framework.dtype import convert_dtype
from ..framework.errors import InvalidArgumentError
from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from ..tensor import Tensor
from . import initializer as init
from .layer import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "GRU", "LSTM"]


def _no_sequence_length(sequence_length):
    if sequence_length is not None:
        raise InvalidArgumentError(
            "sequence_length is not ported yet (ROADMAP queue 1 item 8): "
            "paddle_tpu accepts it and ignores it")


def _zeros(x, batch, hidden):
    """A float32 ``[batch, hidden]`` zero state where ``x`` lies."""
    return Tensor(torch.zeros((batch, hidden), dtype=torch.float32,
                              device=x.place))


def _gru(x, h, w_ih, w_hh, b_ih, b_hh):
    gi = torch.matmul(x, w_ih.t())
    gh = torch.matmul(h, w_hh.t())
    if b_ih is not None:
        gi = gi + b_ih
    if b_hh is not None:
        gh = gh + b_hh
    ri, zi, ci = gi.chunk(3, dim=-1)
    rh, zh, ch = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ri + rh)
    z = torch.sigmoid(zi + zh)
    c = torch.tanh(ci + r * ch)
    return (1 - z) * c + z * h


def _lstm(z, c):
    i, f, g, o = z.chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        ref = to_tensor_like(batch_ref)
        return Tensor(torch.full(
            (ref.shape[batch_dim_idx], self.hidden_size), init_value,
            dtype=convert_dtype(dtype), device=ref.place))


def _make_cell_params(layer, input_size, hidden_size, n_gates, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr):
    std = 1.0 / math.sqrt(hidden_size)
    u = init.Uniform(-std, std)
    layer.weight_ih = layer.create_parameter(
        [n_gates * hidden_size, input_size], attr=weight_ih_attr,
        default_initializer=u)
    layer.weight_hh = layer.create_parameter(
        [n_gates * hidden_size, hidden_size], attr=weight_hh_attr,
        default_initializer=u)
    layer.bias_ih = None if bias_ih_attr is False else layer.create_parameter(
        [n_gates * hidden_size], attr=bias_ih_attr, is_bias=True,
        default_initializer=u)
    layer.bias_hh = None if bias_hh_attr is False else layer.create_parameter(
        [n_gates * hidden_size], attr=bias_hh_attr, is_bias=True,
        default_initializer=u)


def _cell_args(cell, *head):
    return list(head) + [cell.weight_ih, cell.weight_hh] + [
        b for b in (cell.bias_ih, cell.bias_hh) if b is not None]


def _biased(z, biases):
    for b in biases:
        z = z + b
    return z


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _make_cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu

        def f(x, h, w_ih, w_hh, *biases):
            return act(_biased(torch.matmul(x, w_ih.t())
                               + torch.matmul(h, w_hh.t()), biases))

        h = apply("simple_rnn_cell", f, *_cell_args(
            self, to_tensor_like(inputs), to_tensor_like(states)))
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _make_cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        inputs = to_tensor_like(inputs)
        if states is None:
            b = inputs.shape[0]
            states = (_zeros(inputs, b, self.hidden_size),
                      _zeros(inputs, b, self.hidden_size))
        h, c = states

        def f(x, hh, cc, w_ih, w_hh, *biases):
            return _lstm(_biased(torch.matmul(x, w_ih.t())
                                 + torch.matmul(hh, w_hh.t()), biases), cc)

        new_h, new_c = apply("lstm_cell", f, *_cell_args(
            self, inputs, to_tensor_like(h), to_tensor_like(c)))
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _make_cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)

        def f(x, hh, w_ih, w_hh, *biases):
            # the biases by position, as paddle_tpu reads them
            return _gru(x, hh, w_ih, w_hh, biases[0] if biases else None,
                        biases[1] if len(biases) > 1 else None)

        new_h = apply("gru_cell", f, *_cell_args(
            self, to_tensor_like(inputs), to_tensor_like(states)))
        return new_h, new_h


class RNN(Layer):
    """Runs a cell over the time axis (reversed with ``is_reverse``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        from ..ops.manipulation import stack

        _no_sequence_length(sequence_length)
        inputs = to_tensor_like(inputs)
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        outputs = []
        states = initial_states
        idx = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for t in idx:
            x_t = inputs[:, t] if time_axis == 1 else inputs[t]
            out, states = self.cell(x_t, states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return stack(outputs, axis=time_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops.manipulation import concat

        _no_sequence_length(sequence_length)
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


class _MultiLayerRNN(Layer):
    """A stacked, optionally bidirectional recurrent net: one dispatched
    op per layer and direction, its body a loop over the time steps."""

    MODE = "RNN_TANH"
    N_GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        num_dirs = 2 if self.bidirect else 1
        std = 1.0 / math.sqrt(hidden_size)
        u = init.Uniform(-std, std)
        G = self.N_GATES * hidden_size
        for layer in range(num_layers):
            layer_in = input_size if layer == 0 else hidden_size * num_dirs
            for d in range(num_dirs):
                suffix = f"l{layer}" + ("_reverse" if d == 1 else "")
                for name, shape, attr, is_bias in (
                        ("weight_ih", [G, layer_in], weight_ih_attr, False),
                        ("weight_hh", [G, hidden_size], weight_hh_attr, False),
                        ("bias_ih", [G], bias_ih_attr, True),
                        ("bias_hh", [G], bias_hh_attr, True)):
                    self.add_parameter(
                        f"{name}_{suffix}", self.create_parameter(
                            shape, attr=attr, is_bias=is_bias,
                            default_initializer=u))

    def _step(self, x, state, w_ih, w_hh, b_ih, b_hh):
        raise NotImplementedError

    def _scan_direction(self, seq, suffix, reverse, state0):
        """``seq`` a time-major Tensor ``[T, B, I]``; one dispatched op
        returning the outputs ``[T, B, H]`` and the final state."""
        params = [getattr(self, f"{n}_{suffix}")
                  for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        tuple_state = isinstance(state0, tuple)
        leaves = state0 if tuple_state else (state0,)
        step = self._step

        def f(xs, wi, wh, bi, bh, *s0):
            carry = s0 if tuple_state else s0[0]
            ys = [None] * xs.shape[0]
            order = range(xs.shape[0])
            for t in (reversed(order) if reverse else order):
                carry = step(xs[t], carry, wi, wh, bi, bh)
                ys[t] = carry[0] if tuple_state else carry
            return (torch.stack(ys),) + (carry if tuple_state else (carry,))

        out = apply(f"{self.MODE.lower()}_scan", f, seq, *params, *leaves)
        return out[0], (tuple(out[1:]) if tuple_state else out[1])

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops.manipulation import concat, transpose

        _no_sequence_length(sequence_length)
        inputs = to_tensor_like(inputs)
        x = inputs if self.time_major else transpose(inputs, [1, 0, 2])
        num_dirs = 2 if self.bidirect else 1
        init_states = self._prepare_states(initial_states, x,
                                           self.num_layers * num_dirs)
        final_states = []
        for layer in range(self.num_layers):
            outs = []
            for d in range(num_dirs):
                suffix = f"l{layer}" + ("_reverse" if d == 1 else "")
                ys, carry = self._scan_direction(
                    x, suffix, d == 1, init_states[layer * num_dirs + d])
                outs.append(ys)
                final_states.append(carry)
            x = outs[0] if num_dirs == 1 else concat(outs, axis=-1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                from . import functional as F

                x = F.dropout(x, self.dropout, training=self.training)
        out = x if self.time_major else transpose(x, [1, 0, 2])
        return out, self._collect_states(final_states)

    def _prepare_states(self, initial_states, x, n):
        """One initial state per layer and direction: zeros, or the rows
        of an ``[L·D, B, H]`` tensor."""
        if initial_states is None:
            return [_zeros(x, x.shape[1], self.hidden_size) for _ in range(n)]
        return [initial_states[i] for i in range(n)]

    def _collect_states(self, finals):
        from ..ops.manipulation import stack

        return stack(finals, axis=0)


class SimpleRNN(_MultiLayerRNN):
    MODE = "RNN_TANH"
    N_GATES = 1

    def _step(self, x, h, w_ih, w_hh, b_ih, b_hh):
        act = torch.tanh if self.activation == "tanh" else torch.relu
        return act(torch.matmul(x, w_ih.t()) + b_ih
                   + torch.matmul(h, w_hh.t()) + b_hh)


class GRU(SimpleRNN):
    MODE = "GRU"
    N_GATES = 3

    def _step(self, x, h, w_ih, w_hh, b_ih, b_hh):
        return _gru(x, h, w_ih, w_hh, b_ih, b_hh)


class LSTM(_MultiLayerRNN):
    MODE = "LSTM"
    N_GATES = 4

    def _step(self, x, state, w_ih, w_hh, b_ih, b_hh):
        h, c = state
        return _lstm(torch.matmul(x, w_ih.t()) + b_ih
                     + torch.matmul(h, w_hh.t()) + b_hh, c)

    def _prepare_states(self, initial_states, x, n):
        """One ``(h, c)`` per layer and direction: zeros, or the rows of
        ``(h0, c0)``, each ``[L·D, B, H]``."""
        if initial_states is None:
            return [(_zeros(x, x.shape[1], self.hidden_size),
                     _zeros(x, x.shape[1], self.hidden_size))
                    for _ in range(n)]
        h0, c0 = initial_states
        return [(h0[i], c0[i]) for i in range(n)]

    def _collect_states(self, finals):
        from ..ops.manipulation import stack

        return (stack([f[0] for f in finals], axis=0),
                stack([f[1] for f in finals], axis=0))
