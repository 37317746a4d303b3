"""Recurrent layers: SimpleRNN / LSTM / GRU + cells (port of
paddle_tpu/nn/layer/rnn.py).

The reference runs the time loop as a ``lax.scan`` inside one traced op,
outside any Pallas kernel; the port runs it as a Python loop of torch
ops inside one funnel op, with each layer's input projection for every
step in one product before the loop. Gate order is the reference's:
``i, f, g, o`` for the LSTM; the GRU applies ``r`` to
``h @ w_hh^T + b_hh``. The inter-layer dropout draws its mask from the
port's generator (core/random.py): the reference's distribution, other
bits.
"""

from __future__ import annotations

import math

import torch

from ...core import random as prandom
from ...core.dispatch import op
from ...core.tensor import Tensor
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNN", "LSTM", "GRU", "RNN", "BiRNN",
           "SimpleRNNCell", "LSTMCell", "GRUCell"]


def _linear(x, w, b):
    out = x @ w.T
    return out + b if b is not None else out


def _cell_step(mode, gates_x, h, c, w_hh, b_hh):
    """One recurrence step from the input's projection ``gates_x`` =
    x_t @ w_ih^T + b_ih [B, G]; returns (h_new, c_new)."""
    if mode == "LSTM":
        gates = gates_x + _linear(h, w_hh, b_hh)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, c_new
    if mode == "GRU":
        gates_h = _linear(h, w_hh, b_hh)
        xr, xz, xn = torch.chunk(gates_x, 3, dim=-1)
        hr, hz, hn = torch.chunk(gates_h, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        return h_new, c
    # SimpleRNN
    act = torch.tanh if mode == "RNN_TANH" else torch.relu
    return act(gates_x + _linear(h, w_hh, b_hh)), c


def _scan_layer(mode, x, h0, c0, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """x: [T, B, I] time-major. Returns (outputs [T, B, H], h_T, c_T)."""
    gates_x = _linear(x, w_ih, b_ih)
    h, c = h0, c0
    outs = [None] * x.shape[0]
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in steps:
        h, c = _cell_step(mode, gates_x[t], h, c, w_hh, b_hh)
        outs[t] = h
    return torch.stack(outs), h, c


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        else:
            self.num_directions = 1
        self.direction = direction
        gate_mult = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}[mode]
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = (
                    input_size if layer == 0
                    else hidden_size * self.num_directions
                )
                suffix = "_reverse" if d == 1 else ""
                w_ih = self.create_parameter(
                    [gate_mult * hidden_size, in_size], attr=weight_ih_attr,
                    default_initializer=init)
                w_hh = self.create_parameter(
                    [gate_mult * hidden_size, hidden_size],
                    attr=weight_hh_attr, default_initializer=init)
                b_ih = self.create_parameter(
                    [gate_mult * hidden_size], attr=bias_ih_attr, is_bias=True,
                    default_initializer=init)
                b_hh = self.create_parameter(
                    [gate_mult * hidden_size], attr=bias_hh_attr, is_bias=True,
                    default_initializer=init)
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}",
                         f"bias_ih_l{layer}{suffix}",
                         f"bias_hh_l{layer}{suffix}"]
                for n, p in zip(names, [w_ih, w_hh, b_ih, b_hh]):
                    self.add_parameter(n, p)
                self._all_weights.append(names)

    def _weights_flat(self):
        flat = []
        for names in self._all_weights:
            flat.extend(self._parameters[n] for n in names)
        return flat

    def forward(self, inputs, initial_states=None, sequence_length=None):
        mode = self.mode
        num_layers = self.num_layers
        num_dirs = self.num_directions
        hidden = self.hidden_size
        time_major = self.time_major
        dropout = self.dropout if self.training else 0.0
        weights = self._weights_flat()

        gen = None
        if dropout > 0.0 and num_layers > 1:
            gen = prandom.default_generator().torch_generator(
                inputs._data.device)

        has_init = initial_states is not None
        init_list = []
        if has_init:
            if mode == "LSTM":
                init_list = [initial_states[0], initial_states[1]]
            else:
                init_list = [initial_states]

        @op(f"rnn_{mode.lower()}")
        def _impl(x, *flat):
            n_w = 4 * num_layers * num_dirs
            ws = flat[:n_w]
            inits = flat[n_w:]
            if not time_major:
                x = x.transpose(0, 1)  # [T, B, I]
            B = x.shape[1]
            if inits:
                if mode == "LSTM":
                    h0_all, c0_all = inits
                else:
                    h0_all = inits[0]
                    c0_all = torch.zeros_like(h0_all)
            else:
                h0_all = torch.zeros((num_layers * num_dirs, B, hidden),
                                     dtype=x.dtype, device=x.device)
                c0_all = torch.zeros_like(h0_all)

            layer_in = x
            h_finals, c_finals = [], []
            idx = 0
            for layer in range(num_layers):
                outs = []
                for d in range(num_dirs):
                    w_ih, w_hh, b_ih, b_hh = ws[4 * idx: 4 * idx + 4]
                    state_i = layer * num_dirs + d
                    out, h_f, c_f = _scan_layer(
                        mode, layer_in, h0_all[state_i], c0_all[state_i],
                        w_ih, w_hh, b_ih, b_hh, reverse=(d == 1))
                    outs.append(out)
                    h_finals.append(h_f)
                    c_finals.append(c_f)
                    idx += 1
                layer_in = outs[0] if num_dirs == 1 else torch.cat(
                    outs, dim=-1)
                if gen is not None and layer < num_layers - 1:
                    keep = 1.0 - dropout
                    mask = torch.rand(tuple(layer_in.shape), generator=gen,
                                      device=layer_in.device) < keep
                    layer_in = torch.where(
                        mask, layer_in / keep,
                        torch.zeros((), dtype=layer_in.dtype,
                                    device=layer_in.device)).to(
                                        layer_in.dtype)
            out = layer_in
            if not time_major:
                out = out.transpose(0, 1)
            return out, torch.stack(h_finals), torch.stack(c_finals)

        out, h_n, c_n = _impl(inputs, *weights, *init_list)
        if mode == "LSTM":
            return out, (h_n, c_n)
        return out, h_n


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class _CellBase(Layer):
    def __init__(self, mode, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        gate_mult = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}[mode]
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [gate_mult * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gate_mult * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            [gate_mult * hidden_size], attr=bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            [gate_mult * hidden_size], attr=bias_hh_attr, is_bias=True,
            default_initializer=init)

    def _run(self, inputs, h, c):
        mode = self.mode

        @op(f"rnn_cell_{mode.lower()}")
        def _impl(x, hh, cc, w_ih, w_hh, b_ih, b_hh):
            return _cell_step(mode, _linear(x, w_ih, b_ih), hh, cc, w_hh,
                              b_hh)

        return _impl(inputs, h, c, self.weight_ih, self.weight_hh,
                     self.bias_ih, self.bias_hh)


def _zero_state(inputs, hidden):
    d = inputs._data
    return Tensor(torch.zeros((d.shape[0], hidden), dtype=d.dtype,
                              device=d.device))


class SimpleRNNCell(_CellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            states = _zero_state(inputs, self.hidden_size)
        h, _ = self._run(inputs, states, states)
        return h, h


class LSTMCell(_CellBase):
    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            z = _zero_state(inputs, self.hidden_size)
            states = (z, z)
        h, c = self._run(inputs, states[0], states[1])
        return h, (h, c)


class GRUCell(_CellBase):
    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__("GRU", input_size, hidden_size, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            states = _zero_state(inputs, self.hidden_size)
        h, _ = self._run(inputs, states, states)
        return h, h


class RNN(Layer):
    """Wraps a cell into a time loop (reference: nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        # python-loop fallback over the cell (cells are arbitrary user Layers)
        from ...ops import manipulation as M

        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outs = []
        for t in steps:
            x_t = inputs[:, t] if time_axis == 1 else inputs[t]
            out, states = self.cell(x_t, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        outputs = M.stack(outs, axis=time_axis)
        return outputs, states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops import manipulation as M

        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return M.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)
