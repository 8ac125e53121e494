"""Decode-step graph builders: ``(tokens, state) -> (logits, state)``.

Counterpart of ``mxtpu/serving/decode/model.py``, symbol for symbol: the
graphs use only ops the port has (``Embedding``, ``FullyConnected``,
``batch_dot``, ``softmax``, ``where``, ``Concat``, ``Reshape``,
``transpose``, ``broadcast_axis``), so the step and prefill programs run
through the ordinary executor, on cuBLAS for the products, with no
decode-specific kernel. Parameter names are mxtpu's (``embed``,
``lstm_l<k>_*`` / ``attn_l<k>_{q,k,v,o,ff1,ff2}``, ``pred``), so a weight
dict from mxtpu (``convert.params_from_mxtpu``) binds unchanged.

* :func:`lm_step_symbol`: the bucketed LSTM LM as one step, the
  recurrent state promoted to explicit ``decode_state_<i>`` inputs and
  outputs (served from a :class:`SequenceSlotArena`);
* :func:`attn_step_symbol` / :func:`attn_prefill_symbol`: the paged
  attention decode pair over a :class:`PagedArena`'s gathered view.
  Masked scores and padded value rows are replaced with ``where``, never
  multiplied by zero, so garbage (NaN included) in a padded block cannot
  reach a live lane;
* :func:`lm_decode_fixture` / :func:`attn_decode_fixture`: seeded,
  ready-to-serve bundles, mxtpu's weights drawn from the same seed, held
  as host numpy arrays (as ``models.serving_fixtures``'), so a session
  puts them on the context it serves on.
"""
from __future__ import annotations

import numpy as _np

from ... import symbol as _sym
from ...base import MXNetError

__all__ = ["lm_step_symbol", "lm_decode_fixture", "attn_step_symbol",
           "attn_prefill_symbol", "attn_decode_fixture"]


def lm_step_symbol(vocab_size, num_embed, num_hidden, num_layers=2,
                   cell=None):
    """Single-step LSTM-LM graph: ``data`` ``(N, 1)`` token ids +
    ``decode_state_*`` ``(N, H)`` states -> ``Group([logits (N, V)] +
    next states)``.

    ``cell`` overrides the default stacked ``LSTMCell`` (any
    ``BaseRNNCell`` whose ``state_info`` shapes are ``(batch, ...)``).
    Returns ``(symbol, state_names, state_specs)`` where ``state_specs``
    is the per-sequence :meth:`state_spec` list at batch 1 — exactly
    what ``SequenceSlotArena`` and ``DecodeSession`` consume."""
    from ...rnn import LSTMCell, SequentialRNNCell
    if cell is None:
        cell = SequentialRNNCell()
        for i in range(num_layers):
            cell.add(LSTMCell(num_hidden=num_hidden,
                              prefix="lstm_l%d_" % i))
    cell.reset()
    specs = cell.state_spec(1)
    for s in specs:
        if len(s["shape"]) != 2:
            raise MXNetError(
                "lm_step_symbol serves (batch, features) states; got "
                "state shape %s — unfuse/flatten the cell first"
                % (s["shape"],))
    data = _sym.Variable("data")
    embed = _sym.Embedding(data=data, input_dim=int(vocab_size),
                           output_dim=int(num_embed), name="embed")
    states_in = [_sym.Variable("decode_state_%d" % i)
                 for i in range(len(specs))]
    outputs, next_states = cell.unroll(1, inputs=embed,
                                       begin_state=states_in,
                                       merge_outputs=True)
    pred = _sym.Reshape(outputs, shape=(-1, int(num_hidden)))
    logits = _sym.FullyConnected(data=pred, num_hidden=int(vocab_size),
                                 name="pred")
    group = _sym.Group([logits] + list(next_states))
    state_names = ["decode_state_%d" % i for i in range(len(specs))]
    return group, state_names, specs


def lm_decode_fixture(vocab_size=16, num_embed=8, num_hidden=16,
                      num_layers=2, seed=0):
    """A ready-to-serve tiny LM decoder: ``(symbol_json, params,
    example_shapes, state_names, meta)`` with seeded random weights in
    the checkpoint ``arg:`` convention — the decode analogue of
    ``models/serving_fixtures.py`` (tests, bench_decode, examples).

    ``example_shapes`` carries per-request shapes with leading dim 1
    for EVERY input (tokens and states), which is what ``DecodeSession``
    / ``ExecutorPool.bucket_shapes`` substitute bucket sizes into."""
    sym, state_names, specs = lm_step_symbol(
        vocab_size, num_embed, num_hidden, num_layers=num_layers)
    example_shapes = {"data": (1, 1)}
    for name, spec in zip(state_names, specs):
        example_shapes[name] = (1,) + spec["shape"][1:]
    rng = _np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**example_shapes)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in example_shapes:
            continue
        fan_in = int(_np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        scale = 1.0 / max(1.0, float(_np.sqrt(fan_in)))
        params["arg:" + name] = rng.uniform(
            -scale, scale, size=shape).astype(_np.float32)
    meta = {"vocab_size": int(vocab_size), "num_embed": int(num_embed),
            "num_hidden": int(num_hidden), "num_layers": int(num_layers),
            "seed": int(seed)}
    return sym.tojson(), params, example_shapes, state_names, meta


def _attn_proj(x, layer, tag, num_hidden):
    """One named projection — the names are SHARED between the step and
    prefill graphs (``attn_l<k>_{q,k,v,o,ff1,ff2}``), so one ``arg:``
    dict binds both and prefill-primed caches are byte-compatible with
    step-built ones."""
    return _sym.FullyConnected(data=x, num_hidden=int(num_hidden),
                               name="attn_l%d_%s" % (layer, tag))


def attn_step_symbol(vocab_size, num_embed, num_heads, head_dim,
                     max_blocks, block_size, num_layers=1):
    """Block-table-aware single-step attention decoder.

    Inputs (``B`` = bucket, ``T = max_blocks × block_size``):

    * ``data`` ``(B, 1)`` — current token ids;
    * ``attn_mask`` ``(B, T)`` — 1.0 over the sequence's CACHED
      positions (position ``t`` of the gathered view holds cached token
      ``t`` — the block table lists blocks in allocation order). The
      current token is NOT in the cache; its self-attention score is
      concatenated unmasked;
    * per layer ``kv_k_<i>`` / ``kv_v_<i>`` ``(B, max_blocks, block,
      heads, dim)`` — the :meth:`PagedArena.gather_view` output. Padded
      tail blocks hold clipped garbage BY DESIGN; every score into them
      is replaced via ``where`` (−1e30) and their V rows are
      select-zeroed, so garbage — NaN included — cannot reach a live
      lane (0·NaN == NaN is exactly the hazard ``where`` avoids).

    Outputs: ``Group([logits (B, V)] + [k_row, v_row per layer])`` with
    k/v rows shaped ``(B, heads, dim)`` — the exact
    :meth:`PagedArena.scatter_rows` payload for the current position.
    """
    V, E = int(vocab_size), int(num_embed)
    H, D = int(num_heads), int(head_dim)
    T = int(max_blocks) * int(block_size)
    scale = 1.0 / float(_np.sqrt(D))
    data = _sym.Variable("data")
    mask = _sym.Variable("attn_mask")
    x = _sym.Reshape(_sym.Embedding(data=data, input_dim=V, output_dim=E,
                                    name="embed"), shape=(-1, E))
    # (B, T) -> (B*H, 1, T) score mask / (B*H, T, D) value mask
    mask_h = _sym.Reshape(
        _sym.broadcast_axis(_sym.expand_dims(mask, axis=1),
                            axis=(1,), size=(H,)), shape=(-1, 1, T))
    mask_v = _sym.broadcast_axis(
        _sym.Reshape(mask_h, shape=(-1, T, 1)), axis=(2,), size=(D,))
    kv_rows = []
    for i in range(num_layers):
        kc = _sym.Variable("kv_k_%d" % i)
        vc = _sym.Variable("kv_v_%d" % i)
        q = _attn_proj(x, i, "q", H * D)
        k = _attn_proj(x, i, "k", H * D)
        v = _attn_proj(x, i, "v", H * D)
        # heads are contiguous D-chunks: (B, H*D) -> (B*H, 1, D)
        q_m = _sym.Reshape(q, shape=(-1, 1, D))
        k_m = _sym.Reshape(k, shape=(-1, 1, D))
        v_m = _sym.Reshape(v, shape=(-1, 1, D))
        # (B, MB, BLK, H, D) -> (B, T, H, D) -> (B, H, T, D) -> (B*H, T, D)
        kc_m = _sym.Reshape(_sym.transpose(
            _sym.Reshape(kc, shape=(-1, T, H, D)), axes=(0, 2, 1, 3)),
            shape=(-1, T, D))
        vc_m = _sym.Reshape(_sym.transpose(
            _sym.Reshape(vc, shape=(-1, T, H, D)), axes=(0, 2, 1, 3)),
            shape=(-1, T, D))
        s_cache = _sym.batch_dot(q_m, kc_m, transpose_b=True) * scale
        s_cache = _sym.where(mask_h, s_cache, mask_h * 0.0 - 1e30)
        s_self = _sym.batch_dot(q_m, k_m, transpose_b=True) * scale
        p = _sym.softmax(_sym.Concat(s_cache, s_self, dim=2), axis=-1)
        # select-not-multiply: vc_m may be NaN garbage in padded blocks
        vcat = _sym.Concat(_sym.where(mask_v, vc_m, mask_v * 0.0),
                           v_m, dim=1)
        attn = _sym.Reshape(_sym.batch_dot(p, vcat), shape=(-1, H * D))
        x = x + _attn_proj(attn, i, "o", E)
        ff = _sym.Activation(_attn_proj(x, i, "ff1", 2 * E),
                             act_type="relu")
        x = x + _attn_proj(ff, i, "ff2", E)
        kv_rows += [_sym.Reshape(k, shape=(-1, H, D)),
                    _sym.Reshape(v, shape=(-1, H, D))]
    logits = _sym.FullyConnected(data=x, num_hidden=V, name="pred")
    return _sym.Group([logits] + kv_rows)


def attn_prefill_symbol(vocab_size, num_embed, num_heads, head_dim,
                        max_blocks, block_size, num_layers=1):
    """Chunked prefill graph: ONE sequence, ``C`` prompt tokens per
    call (``C`` is the bucket axis — leading on the token-parallel
    inputs, both axes of the in-chunk causal mask).

    Inputs (``T = max_blocks × block_size``):

    * ``data`` ``(C, 1)`` — chunk token ids (pad rows: token 0);
    * ``attn_mask_cache`` ``(C, T)`` — 1.0 over positions already
      cached by earlier chunks (same for every valid row; all-zero for
      pad rows);
    * ``attn_mask_chunk`` ``(C, C)`` — causal within the chunk
      (``j ≤ c``) for valid rows; pad rows carry ONLY the self bit
      ``[c, c]`` so their softmax never sees an all-−1e30 row (NaN);
    * ``kv_valid_cache`` ``(1, T)`` / ``chunk_valid`` ``(C, 1)`` — KEY
      validity, select-zeroing V rows so garbage cache blocks and pad
      chunk rows are inert as values exactly like the step graph;
    * per layer ``kv_k_<i>`` / ``kv_v_<i>`` ``(1, max_blocks, block,
      heads, dim)`` — the single sequence's gathered view.

    Outputs: ``Group([logits (C, V)] + [k_row, v_row per layer])`` with
    ``(C, heads, dim)`` rows — scattered at positions ``p0..p0+C−1``
    (pad rows go to the drop sentinel). ``logits[C_valid−1]`` of the
    FINAL chunk is the first sampled token — time-to-first-token is
    observed there.
    """
    V, E = int(vocab_size), int(num_embed)
    H, D = int(num_heads), int(head_dim)
    T = int(max_blocks) * int(block_size)
    scale = 1.0 / float(_np.sqrt(D))
    data = _sym.Variable("data")
    mask_cache = _sym.Variable("attn_mask_cache")
    mask_chunk = _sym.Variable("attn_mask_chunk")
    kv_valid = _sym.Variable("kv_valid_cache")
    chunk_valid = _sym.Variable("chunk_valid")
    x = _sym.Reshape(_sym.Embedding(data=data, input_dim=V, output_dim=E,
                                    name="embed"), shape=(-1, E))
    mc_h = _sym.broadcast_axis(_sym.expand_dims(mask_cache, axis=0),
                               axis=(0,), size=(H,))          # (H, C, T)
    mk_h = _sym.broadcast_axis(_sym.expand_dims(mask_chunk, axis=0),
                               axis=(0,), size=(H,))          # (H, C, C)
    vm_cache = _sym.broadcast_axis(_sym.expand_dims(
        _sym.broadcast_axis(_sym.Reshape(kv_valid, shape=(T, 1)),
                            axis=(1,), size=(D,)), axis=0),
        axis=(0,), size=(H,))                             # (H, T, D)
    vm_chunk = _sym.broadcast_axis(_sym.expand_dims(
        _sym.broadcast_axis(chunk_valid, axis=(1,), size=(D,)), axis=0),
        axis=(0,), size=(H,))                             # (H, C, D)
    kv_rows = []
    for i in range(num_layers):
        kc = _sym.Variable("kv_k_%d" % i)
        vc = _sym.Variable("kv_v_%d" % i)
        q = _attn_proj(x, i, "q", H * D)
        k = _attn_proj(x, i, "k", H * D)
        v = _attn_proj(x, i, "v", H * D)
        # token-parallel layout: (C, H*D) -> (C, H, D) -> (H, C, D)
        q_h = _sym.transpose(_sym.Reshape(q, shape=(-1, H, D)),
                             axes=(1, 0, 2))
        k_h = _sym.transpose(_sym.Reshape(k, shape=(-1, H, D)),
                             axes=(1, 0, 2))
        v_h = _sym.transpose(_sym.Reshape(v, shape=(-1, H, D)),
                             axes=(1, 0, 2))
        # (1, MB, BLK, H, D) -> (T, H, D) -> (H, T, D)
        kc_h = _sym.transpose(_sym.Reshape(kc, shape=(-1, H, D)),
                              axes=(1, 0, 2))
        vc_h = _sym.transpose(_sym.Reshape(vc, shape=(-1, H, D)),
                              axes=(1, 0, 2))
        s_c = _sym.batch_dot(q_h, kc_h, transpose_b=True) * scale
        s_c = _sym.where(mc_h, s_c, mc_h * 0.0 - 1e30)
        s_k = _sym.batch_dot(q_h, k_h, transpose_b=True) * scale
        s_k = _sym.where(mk_h, s_k, mk_h * 0.0 - 1e30)
        p = _sym.softmax(_sym.Concat(s_c, s_k, dim=2), axis=-1)
        vcat = _sym.Concat(_sym.where(vm_cache, vc_h, vm_cache * 0.0),
                           _sym.where(vm_chunk, v_h, vm_chunk * 0.0),
                           dim=1)                          # (H, T+C, D)
        attn = _sym.Reshape(_sym.transpose(_sym.batch_dot(p, vcat),
                                           axes=(1, 0, 2)),
                            shape=(-1, H * D))             # (C, H*D)
        x = x + _attn_proj(attn, i, "o", E)
        ff = _sym.Activation(_attn_proj(x, i, "ff1", 2 * E),
                             act_type="relu")
        x = x + _attn_proj(ff, i, "ff2", E)
        kv_rows += [_sym.Reshape(k, shape=(-1, H, D)),
                    _sym.Reshape(v, shape=(-1, H, D))]
    logits = _sym.FullyConnected(data=x, num_hidden=V, name="pred")
    return _sym.Group([logits] + kv_rows)


def attn_decode_fixture(vocab_size=16, num_embed=8, num_heads=2,
                        head_dim=4, num_layers=1, block_size=4,
                        max_blocks_per_seq=4, seed=0):
    """A ready-to-serve tiny paged attention decoder: the ``paged``
    bundle :class:`DecodeSession` consumes in ``kv`` layout, with
    seeded random weights shared between the step and prefill graphs.

    Returns a dict with ``step_symbol_json`` / ``step_example_shapes``
    (bucket at axis 0 of every input), ``prefill_symbol_json`` /
    ``prefill_example_shapes`` / ``prefill_bucket_axes`` (chunk on the
    token-parallel inputs only — the KV view and its validity mask keep
    fixed shapes), ``params``, ``kv_specs`` (per-TOKEN trailing shapes
    for :class:`PagedArena`), geometry ints and ``meta``."""
    H, D = int(num_heads), int(head_dim)
    MB, BLK = int(max_blocks_per_seq), int(block_size)
    T = MB * BLK
    step = attn_step_symbol(vocab_size, num_embed, H, D, MB, BLK,
                            num_layers=num_layers)
    prefill = attn_prefill_symbol(vocab_size, num_embed, H, D, MB, BLK,
                                  num_layers=num_layers)
    kv_specs = []
    for i in range(num_layers):
        kv_specs += [{"name": "kv_k_%d" % i, "shape": (H, D),
                      "dtype": "float32"},
                     {"name": "kv_v_%d" % i, "shape": (H, D),
                      "dtype": "float32"}]
    step_shapes = {"data": (1, 1), "attn_mask": (1, T)}
    prefill_shapes = {"data": (1, 1), "attn_mask_cache": (1, T),
                      "attn_mask_chunk": (1, 1),
                      "kv_valid_cache": (1, T), "chunk_valid": (1, 1)}
    prefill_bucket_axes = {"data": (0,), "attn_mask_cache": (0,),
                           "attn_mask_chunk": (0, 1),
                           "chunk_valid": (0,), "kv_valid_cache": ()}
    for s in kv_specs:
        step_shapes[s["name"]] = (1, MB, BLK, H, D)
        prefill_shapes[s["name"]] = (1, MB, BLK, H, D)
        prefill_bucket_axes[s["name"]] = ()
    rng = _np.random.RandomState(seed)
    arg_shapes, _, _ = step.infer_shape(**step_shapes)
    params = {}
    for name, shape in zip(step.list_arguments(), arg_shapes):
        if name in step_shapes:
            continue
        fan_in = int(_np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        scale = 1.0 / max(1.0, float(_np.sqrt(fan_in)))
        params["arg:" + name] = rng.uniform(
            -scale, scale, size=shape).astype(_np.float32)
    return {
        "step_symbol_json": step.tojson(),
        "step_example_shapes": step_shapes,
        "prefill_symbol_json": prefill.tojson(),
        "prefill_example_shapes": prefill_shapes,
        "prefill_bucket_axes": prefill_bucket_axes,
        "params": params,
        "kv_specs": kv_specs,
        "block_size": BLK,
        "max_blocks_per_seq": MB,
        "meta": {"vocab_size": int(vocab_size),
                 "num_embed": int(num_embed), "num_heads": H,
                 "head_dim": D, "num_layers": int(num_layers),
                 "block_size": BLK, "max_blocks_per_seq": MB,
                 "seed": int(seed)},
    }
