"""The fused RNN operator (``RNN``) and its weight-layout helpers.

Counterpart of ``mxtpu/ops/rnn.py``: the op registered with mxtpu's args,
attrs and defaults (:283-289), its infer-args shapes (:266-280), the
batch-1 initial state broadcast (:213-219), and the helpers
``rnn_param_size``, ``rnn_infer_input_size``, ``rnn_pack_weights``,
``rnn_unpack_weights``, ``GATE_COUNT`` and ``GATE_NAMES``.

The flat ``parameters`` vector holds, for each layer and then each
direction (forward, then backward when bidirectional), ``Wx (G*H, I_l)``,
``Wh (G*H, H)``, ``bx (G*H,)`` and ``bh (G*H,)``, with the gates ``i, f,
g, o`` for lstm and ``r, z, n`` for gru, whose candidate is ``n =
tanh(W_in x + b_in + r * (W_hn h + b_hn))`` (mxtpu :151-183). That is
torch's per-layer ``w_ih, w_hh, b_ih, b_hh`` in torch's order, so the
same vector is a checkpoint of either package and the weight list of
torch's functional RNN. Data is (T, N, I), states (L*D, N, H).

Two routes, chosen from the tensor's device and the attrs:

- ``_vf_rnn`` (a CUDA tensor without the LSTM state clip): cuDNN's RNN
  through torch's functional ``torch._VF.lstm``/``gru``/``rnn_tanh``/
  ``rnn_relu`` on views of the flat vector, ``train`` set when training
  or when a gradient is wanted (cuDNN's backward needs the training
  forward's reserve), dropout ``p`` between layers only in training,
  drawn from cuDNN's own dropout state. Where those views do not sit in
  cuDNN's own weight layout, torch copies them into a cuDNN buffer on
  each call (and warns once). A tensor cuDNN does not accept
  (``torch.backends.cudnn.is_acceptable``) raises: there is no fallback.
- ``_loop_rnn`` (a CPU tensor, and the declared route for the LSTM state
  clip on the card, which cuDNN's RNN through torch does not offer): a
  per-step loop that mirrors mxtpu's ``_cell_step``/``_run_direction``
  op for op; a reverse direction scans t = T-1..0 and stacks its outputs
  in input order (mxtpu :189-192). Its dropout between layers draws from
  the device's generator (``random.generator``).

``ROUTES`` counts the calls of each route.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from .registry import Required, register, set_replicas

__all__ = ["rnn_param_size", "rnn_infer_input_size", "rnn_pack_weights",
           "rnn_unpack_weights", "GATE_COUNT", "GATE_NAMES", "ROUTES"]

GATE_COUNT = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
GATE_NAMES = {"rnn_relu": [""], "rnn_tanh": [""],
              "lstm": ["i", "f", "c", "o"], "gru": ["r", "z", "o"]}
ROUTES = {"cudnn": 0, "loop": 0}


def _layer_input_size(layer, input_size, state_size, num_directions):
    return input_size if layer == 0 else state_size * num_directions


def _layer_sizes(mode, layer, input_size, state_size, num_directions):
    """(Wx, Wh, bx, bh) element counts for one (layer, direction)."""
    gates = GATE_COUNT[mode]
    i = _layer_input_size(layer, input_size, state_size, num_directions)
    h = state_size
    return gates * h * i, gates * h * h, gates * h, gates * h


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False):
    """Total element count of the flat ``parameters`` vector."""
    d = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        total += d * sum(_layer_sizes(mode, layer, input_size, state_size,
                                      d))
    return total


def rnn_infer_input_size(flat_size, num_layers, state_size, mode,
                         bidirectional=False):
    """The layer-0 input size of a flat ``parameters`` vector of
    ``flat_size`` elements (the inverse of ``rnn_param_size``)."""
    d = 2 if bidirectional else 1
    g = GATE_COUNT[mode]
    h = state_size
    return int(flat_size // d // h // g) - \
        (num_layers - 1) * (h + d * h + 2) - h - 2


def _unpack(params, num_layers, input_size, state_size, mode,
            num_directions):
    """flat vector (numpy or torch) -> [layer][direction] of
    (Wx, Wh, bx, bh) views."""
    gates = GATE_COUNT[mode]
    h = state_size
    out = []
    off = 0
    for layer in range(num_layers):
        i = _layer_input_size(layer, input_size, state_size, num_directions)
        per_dir = []
        for _d in range(num_directions):
            nwx, nwh, nbx, nbh = _layer_sizes(mode, layer, input_size, h,
                                              num_directions)
            wx = params[off:off + nwx].reshape(gates * h, i)
            off += nwx
            wh = params[off:off + nwh].reshape(gates * h, h)
            off += nwh
            bx = params[off:off + nbx]
            off += nbx
            bh = params[off:off + nbh]
            off += nbh
            per_dir.append((wx, wh, bx, bh))
        out.append(per_dir)
    return out


def rnn_unpack_weights(params, num_layers, input_size, state_size, mode,
                       bidirectional=False):
    """Flat blob -> {name: numpy array} with FusedRNNCell's names such as
    'l0_i2h_i_weight' / 'r0_h2h_f_bias' (l: forward, r: backward)."""
    d = 2 if bidirectional else 1
    layers = _unpack(_np.asarray(params), num_layers, input_size,
                     state_size, mode, d)
    gates, h = GATE_COUNT[mode], state_size
    names = GATE_NAMES[mode]
    out = {}
    for layer, per_dir in enumerate(layers):
        for di, (wx, wh, bx, bh) in enumerate(per_dir):
            p = ("l%d" if di == 0 else "r%d") % layer
            for g in range(gates):
                suf = ("_%s" % names[g]) if names[g] else ""
                out["%s_i2h%s_weight" % (p, suf)] = wx[g * h:(g + 1) * h]
                out["%s_h2h%s_weight" % (p, suf)] = wh[g * h:(g + 1) * h]
                out["%s_i2h%s_bias" % (p, suf)] = bx[g * h:(g + 1) * h]
                out["%s_h2h%s_bias" % (p, suf)] = bh[g * h:(g + 1) * h]
    return out


def rnn_pack_weights(weights, num_layers, input_size, state_size, mode,
                     bidirectional=False, dtype="float32"):
    """Inverse of rnn_unpack_weights: {name: array} -> flat numpy blob."""
    d = 2 if bidirectional else 1
    gates = GATE_COUNT[mode]
    names = GATE_NAMES[mode]
    parts = []
    for layer in range(num_layers):
        for di in range(d):
            p = ("l%d" if di == 0 else "r%d") % layer
            for kind in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
                rows = []
                for g in range(gates):
                    suf = ("_%s" % names[g]) if names[g] else ""
                    key = "%s_%s%s_%s" % (p, kind.split("_")[0], suf,
                                          kind.split("_")[1])
                    rows.append(_np.asarray(weights[key], dtype=dtype))
                parts.append(_np.concatenate([r.reshape(-1) for r in rows]))
    return _np.concatenate(parts)


# ---------------------------------------------------------------- the loop
def _cell_step(mode, wx, wh, bx, bh, clip=None):
    """f(x_t, h, c) -> (h', c') of one direction of one layer (mxtpu's
    ``_cell_step``; c is None outside lstm)."""
    if mode == "lstm":
        def step(x, h, c):
            gates = x @ wx.T + bx + h @ wh.T + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip is not None:
                c2 = torch.clamp(c2, clip[0], clip[1])
            return torch.sigmoid(o) * torch.tanh(c2), c2
    elif mode == "gru":
        def step(x, h, c):
            xr, xz, xn = (x @ wx.T + bx).chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            return (1 - z) * n + z * h, None
    else:
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(x, h, c):
            return act(x @ wx.T + bx + h @ wh.T + bh), None
    return step


def _run_direction(mode, x, h0, c0, w, reverse, clip=None):
    """Scan one direction over time: x (T, N, I) -> (out (T, N, H), hT,
    cT); a reverse scan stacks its outputs in input order."""
    step = _cell_step(mode, *w, clip=clip)
    h, c = h0, c0
    outs = [None] * x.shape[0]
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in order:
        h, c = step(x[t], h, c)
        outs[t] = h
    return torch.stack(outs), h, c


def _loop_rnn(a, gen, data, layers, state, state_cell, clip):
    mode = a.mode
    d = 2 if a.bidirectional else 1
    p = float(a.p)
    x = data
    h_outs, c_outs = [], []
    for layer in range(int(a.num_layers)):
        if layer > 0 and p > 0 and a.get("__is_train__", False):
            keep = torch.rand(x.shape, generator=gen, device=x.device) \
                < 1.0 - p
            x = torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        dir_outs = []
        for di in range(d):
            c0 = state_cell[layer * d + di] if mode == "lstm" else None
            out, hT, cT = _run_direction(mode, x, state[layer * d + di], c0,
                                         layers[layer][di], reverse=di == 1,
                                         clip=clip)
            dir_outs.append(out)
            h_outs.append(hT)
            if mode == "lstm":
                c_outs.append(cT)
        x = dir_outs[0] if d == 1 else torch.cat(dir_outs, dim=-1)
    return x, torch.stack(h_outs), (torch.stack(c_outs) if c_outs else None)


# ---------------------------------------------------------------- cuDNN
def _vf_rnn(a, data, layers, state, state_cell, train):
    """torch's functional RNN over the flat vector's views, in torch's
    weight order (per layer, per direction: w_ih, w_hh, b_ih, b_hh); on
    a CUDA tensor this is cuDNN's RNN. Returns (out, h_n, c_n or None)."""
    weights = [w for per_dir in layers for wts in per_dir for w in wts]
    hx = (state.contiguous(), state_cell.contiguous()) \
        if a.mode == "lstm" else state.contiguous()
    p = float(a.p) if a.get("__is_train__", False) else 0.0
    res = getattr(torch._VF, a.mode)(
        data.contiguous(), hx, weights, True, int(a.num_layers), p, train,
        bool(a.bidirectional), False)
    return res[0], res[1], (res[2] if a.mode == "lstm" else None)


def _clip_of(a):
    if a.mode == "lstm" and a.get("lstm_state_clip_min") is not None \
            and a.get("lstm_state_clip_max") is not None:
        return (float(a.lstm_state_clip_min), float(a.lstm_state_clip_max))
    return None


def _rnn(a, gen, data, parameters, state, state_cell=None):
    """The fused recurrent layers (TNC): cuDNN on a CUDA tensor, the
    per-step loop on the CPU and for the LSTM state clip."""
    mode = a.mode
    if mode not in GATE_COUNT:
        raise MXNetError("RNN: unknown mode '%s'" % mode)
    num_layers, h_size = int(a.num_layers), int(a.state_size)
    d = 2 if a.bidirectional else 1
    T, N, input_size = data.shape
    if parameters.numel() != rnn_param_size(num_layers, input_size, h_size,
                                            mode, a.bidirectional):
        raise MXNetError("RNN: parameters has %d elements, the layers need "
                         "%d" % (parameters.numel(), rnn_param_size(
                             num_layers, input_size, h_size, mode,
                             a.bidirectional)))
    if data.device.type == "meta":  # shape inference
        outs = [torch.empty((T, N, h_size * d), dtype=data.dtype,
                            device="meta")]
        if a.state_outputs:
            n = 2 if mode == "lstm" else 1
            outs += [torch.empty((num_layers * d, N, h_size),
                                 dtype=data.dtype, device="meta")] * n
        return tuple(outs)
    # the parameters (as in mxtpu) and the states take the data's type
    layers = _unpack(parameters.to(data.dtype), num_layers, input_size,
                     h_size, mode, d)
    state = state.to(data.dtype)
    if state_cell is not None:
        state_cell = state_cell.to(data.dtype)
    # a batch-1 initial state broadcasts over the batch (mxtpu :213-219)
    full = (num_layers * d, N, h_size)
    if state.shape[1] != N:
        state = state.expand(full)
    if state_cell is not None and state_cell.shape[1] != N:
        state_cell = state_cell.expand(full)
    clip = _clip_of(a)
    if data.device.type == "cuda" and clip is None:
        if not torch.backends.cudnn.is_acceptable(data):
            raise MXNetError("RNN: cuDNN does not accept this %s tensor "
                             "(cudnn enabled=%s); the op has no other "
                             "route on the card without the LSTM state "
                             "clip" % (data.dtype,
                                       torch.backends.cudnn.enabled))
        train = bool(a.get("__is_train__", False)) or (
            torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (data, parameters, state, state_cell)))
        ROUTES["cudnn"] += 1
        out, hn, cn = _vf_rnn(a, data, layers, state, state_cell, train)
    else:
        ROUTES["loop"] += 1
        out, hn, cn = _loop_rnn(a, gen, data, layers, state, state_cell,
                                clip)
    outputs = [out]
    if a.state_outputs:
        outputs.append(hn)
        if mode == "lstm":
            outputs.append(cn)
    return tuple(outputs)


def _rnn_args(a):
    base = ["data", "parameters", "state"]
    if a.get("mode") == "lstm":
        base.append("state_cell")
    return base


def _rnn_nout(a):
    if not a.get("state_outputs"):
        return 1
    return 3 if a.get("mode") == "lstm" else 2


def _rnn_infer(a, shapes):
    """The parameters and state shapes from the data shape (mxtpu
    :266-280)."""
    data = shapes[0]
    if data is None:
        return shapes
    _, N, input_size = data
    h = int(a.state_size)
    d = 2 if a.bidirectional else 1
    L = int(a.num_layers)
    out = [data, (rnn_param_size(L, input_size, h, a.mode,
                                 a.bidirectional),), (L * d, N, h)]
    if a.mode == "lstm":
        out.append((L * d, N, h))
    return out


register("RNN", _rnn, arg_names=_rnn_args,
         attrs={"state_size": Required(int), "num_layers": Required(int),
                "bidirectional": False, "mode": Required(str), "p": 0.0,
                "state_outputs": False, "lstm_state_clip_min": None,
                "lstm_state_clip_max": None, "__is_train__": False},
         num_outputs=_rnn_nout, needs_rng=True, infer_args=_rnn_infer,
         doc=_rnn.__doc__)
set_replicas(["RNN"])
