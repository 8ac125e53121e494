"""The LSTM + CTC optical character recognizer of MXNet's example/ctc.

The port's copy of ``examples/ctc/lstm_ocr.py`` (the 7x5 digit font,
``render_strip``, ``make_dataset``, ``build_symbol``, ``greedy_decode``
and the constants), which imports ``mxtpu`` and cannot be imported by the
port. The strips are synthetic: 3-5 digits drawn from the font at
random offsets into a 16x64 image with uniform noise; two columns make a
step, so a strip is a (T=32, F=32) sequence. Labels follow warp-ctc's
convention: the blank is class 0, digit d is class d + 1, and label 0 is
padding. ``build_symbol`` unrolls two ``LSTMCell``s over the steps into
a fully connected layer of ``NUM_CLASSES`` and ``CTCLoss`` with the blank
first; the prediction symbol ends in a softmax over (T, N, C).
``example_split`` gives the example's training and held-out arrays at its
defaults (3,072 strips, seed 11, 90 % to train).
"""
from __future__ import annotations

import numpy as np

from .. import rnn
from .. import symbol as sym

__all__ = ["IMG_H", "IMG_W", "MAX_LABEL", "NUM_CLASSES", "render_strip",
           "make_dataset", "build_symbol", "greedy_decode", "example_split",
           "decode_accuracy"]

# 7x5 bitmap font for digits 0-9 (rows of 5 bits, msb left)
_FONT = {
    0: "01110 10001 10011 10101 11001 10001 01110",
    1: "00100 01100 00100 00100 00100 00100 01110",
    2: "01110 10001 00001 00010 00100 01000 11111",
    3: "11111 00010 00100 00010 00001 10001 01110",
    4: "00010 00110 01010 10010 11111 00010 00010",
    5: "11111 10000 11110 00001 00001 10001 01110",
    6: "00110 01000 10000 11110 10001 10001 01110",
    7: "11111 00001 00010 00100 01000 01000 01000",
    8: "01110 10001 10001 01110 10001 10001 01110",
    9: "01110 10001 10001 01111 00001 00010 01100",
}
_GLYPHS = {
    d: np.array([[int(b) for b in row] for row in s.split()],
                dtype=np.float32)
    for d, s in _FONT.items()
}

IMG_H, IMG_W = 16, 64
MAX_LABEL = 5          # up to 5 digits per strip
NUM_CLASSES = 11       # blank + 10 digits


def render_strip(digits, rng):
    """Render a digit string into an (IMG_H, IMG_W) float image with
    random vertical jitter and per-digit horizontal spacing."""
    img = np.zeros((IMG_H, IMG_W), dtype=np.float32)
    slack = IMG_W - len(digits) * 7 - 2
    x = 1 + rng.randint(0, max(1, slack // 2))
    for d in digits:
        g = _GLYPHS[d]
        y = 3 + rng.randint(0, 4)
        img[y:y + 7, x:x + 5] = np.maximum(img[y:y + 7, x:x + 5], g)
        x += 7 + rng.randint(0, 2)
    img += rng.uniform(0.0, 0.15, img.shape).astype(np.float32)
    return np.minimum(img, 1.0)


def make_dataset(n, rng):
    """(X (n, T, F) strips as two-column steps, Y (n, MAX_LABEL) labels,
    0-padded)."""
    X = np.zeros((n, IMG_W // 2, IMG_H * 2), dtype=np.float32)
    Y = np.zeros((n, MAX_LABEL), dtype=np.float32)
    for i in range(n):
        k = rng.randint(3, MAX_LABEL + 1)
        digits = [rng.randint(0, 10) for _ in range(k)]
        img = render_strip(digits, rng)
        X[i] = img.T.reshape(IMG_W // 2, IMG_H * 2)
        Y[i, :k] = [d + 1 for d in digits]  # 0 is blank/pad
    return X, Y


def build_symbol(num_hidden, seq_len, for_training):
    """Two LSTMCells over ``seq_len`` steps (NTC), FC to NUM_CLASSES, then
    CTCLoss (training) or a softmax over (T, N, C)."""
    data = sym.Variable("data")            # (N, T, F)
    stack = rnn.SequentialRNNCell()
    stack.add(rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm1_"))
    stack.add(rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm2_"))
    outputs, _ = stack.unroll(seq_len, inputs=data, merge_outputs=True,
                              layout="NTC")
    flat = sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(flat, num_hidden=NUM_CLASSES, name="pred")
    pred = sym.Reshape(pred, shape=(-1, seq_len, NUM_CLASSES))
    pred_tnc = sym.transpose(pred, axes=(1, 0, 2))  # (T, N, C)
    if not for_training:
        return sym.softmax(pred_tnc, axis=-1)
    label = sym.Variable("label")
    return sym.CTCLoss(pred_tnc, label, name="ctc", blank_label="first")


def greedy_decode(probs):
    """probs (T, N, C) -> list of digit lists (collapse repeats, drop
    blank)."""
    ids = probs.argmax(axis=-1)  # (T, N)
    out = []
    for n in range(ids.shape[1]):
        seq, prev = [], -1
        for t in ids[:, n]:
            if t != prev and t != 0:
                seq.append(int(t) - 1)
            prev = t
        out.append(seq)
    return out


def example_split(num_examples=3072, seed=11):
    """The example's data at its defaults: (X_train, Y_train, X_val,
    Y_val), 90 % to train (2,764 strips)."""
    X, Y = make_dataset(num_examples, np.random.RandomState(seed))
    n_train = int(len(X) * 0.9)
    return X[:n_train], Y[:n_train], X[n_train:], Y[n_train:]


def decode_accuracy(probs, labels, n_valid):
    """(correct, total): whole-sequence matches of ``greedy_decode`` of
    ``probs`` (T, N, C) against the 0-padded ``labels`` over the first
    ``n_valid`` sequences."""
    decoded = greedy_decode(probs)
    correct = 0
    for n in range(n_valid):
        want = [int(v) - 1 for v in labels[n] if v > 0]
        correct += int(decoded[n] == want)
    return correct, n_valid
