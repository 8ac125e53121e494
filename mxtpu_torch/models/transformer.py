"""Decoder-only transformer language model (symbol factory).

A copy of ``mxtpu/models/transformer.py``: pre-norm blocks, learned
positions, ReLU feed-forward, untied ``lm_head``. Tokens (B, T) become
embeddings (B, T, D); attention runs in (B, H, T, dh) through
``_contrib_FlashAttention`` (the CUDA kernel on the card); every matmul
is a FullyConnected(flatten=False) along the last axis. The output is
SoftmaxOutput over (B*T, vocab).
"""
from .. import symbol as sym


def _attention_block(h, seq_len, num_heads, d_model, prefix, dropout):
    """Pre-norm causal self-attention sublayer: h + Proj(Attn(LN(h)))."""
    dh = d_model // num_heads
    ln = sym.LayerNorm(h, name="%s_ln1" % prefix)

    def heads(x, tag):
        p = sym.FullyConnected(x, num_hidden=d_model, flatten=False,
                               name="%s_%s" % (prefix, tag))
        p = sym.reshape(p, shape=(-1, seq_len, num_heads, dh))
        return sym.transpose(p, axes=(0, 2, 1, 3))  # (B, H, T, dh)

    q, k, v = heads(ln, "q"), heads(ln, "k"), heads(ln, "v")
    att = sym.contrib.FlashAttention(q, k, v, causal=True,
                                     name="%s_attn" % prefix)
    att = sym.transpose(att, axes=(0, 2, 1, 3))
    att = sym.reshape(att, shape=(-1, seq_len, d_model))
    att = sym.FullyConnected(att, num_hidden=d_model, flatten=False,
                             name="%s_proj" % prefix)
    if dropout > 0:
        att = sym.Dropout(att, p=dropout)
    return h + att


def _ffn_block(h, d_model, d_ff, prefix, dropout):
    """Pre-norm feed-forward sublayer: h + W2(act(W1(LN(h))))."""
    ln = sym.LayerNorm(h, name="%s_ln2" % prefix)
    f = sym.FullyConnected(ln, num_hidden=d_ff, flatten=False,
                           name="%s_ff1" % prefix)
    f = sym.Activation(f, act_type="relu")
    f = sym.FullyConnected(f, num_hidden=d_model, flatten=False,
                           name="%s_ff2" % prefix)
    if dropout > 0:
        f = sym.Dropout(f, p=dropout)
    return h + f


def get_symbol(vocab_size, seq_len, num_layers=2, num_heads=4, d_model=128,
               d_ff=None, dropout=0.0, max_len=None, dtype=None):
    """Causal LM: data (B, T) float token ids -> SoftmaxOutput over
    (B*T, vocab). ``max_len`` sizes the learned positional table apart
    from ``seq_len``; ``dtype='bfloat16'`` casts activations to bf16
    after the embedding and the logits back to f32 before the softmax."""
    d_ff = d_ff or 4 * d_model
    if d_model % num_heads:
        raise ValueError("d_model must divide into heads")
    max_len = max_len or seq_len
    if max_len < seq_len:
        raise ValueError("max_len must cover seq_len")
    data = sym.Variable("data")
    h = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                      name="tok_emb")
    if dtype is not None:
        h = sym.Cast(h, dtype=dtype)
    pos = sym.Variable("pos_emb", shape=(1, max_len, d_model))
    if dtype is not None:
        pos = sym.Cast(pos, dtype=dtype)
    if max_len != seq_len:
        pos = sym.slice_axis(pos, axis=1, begin=0, end=seq_len)
    h = sym.broadcast_add(h, pos)
    for i in range(num_layers):
        p = "l%d" % i
        h = _attention_block(h, seq_len, num_heads, d_model, p, dropout)
        h = _ffn_block(h, d_model, d_ff, p, dropout)
    h = sym.LayerNorm(h, name="ln_f")
    h = sym.reshape(h, shape=(-1, d_model))
    logits = sym.FullyConnected(h, num_hidden=vocab_size, name="lm_head")
    if dtype is not None:
        logits = sym.Cast(logits, dtype="float32")
    return sym.SoftmaxOutput(logits, name="softmax")
