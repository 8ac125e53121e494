"""mxtpu_torch.parallel and the mesh collectives against mxtpu, on the CPU.

The port's meshes here are of host contexts (``cpu(0..7)``, one host
device), mxtpu's of its 8 virtual XLA host devices (conftest). Inputs
are numpy arrays from seeds, handed to both packages.

- The collectives (reduce-scatter, all-gather, ppermute, all-to-all)
  against numpy, and their autograd forms by gradcheck in float64.
- ``make_mesh`` and ``mesh_put`` against mxtpu's shards.
- ``blockwise_attention``, ``ring_attention`` and ``ulysses_attention``,
  output and gradients, causal and not, against mxtpu's on a 4-device
  mesh: output within 1e-4 and gradients within 2e-3 (tests/
  test_parallel.py:91-140, 309-345).
- ``moe_apply``, ``moe_apply_topk`` (ample capacity and capacity drops)
  and ``load_balancing_loss`` with gradients against mxtpu's: rtol 1e-4
  / atol 1e-5 for top-1, 2e-4 / 2e-5 for top-k and 2e-3 / 2e-4 for its
  gradients (tests/test_parallel.py:214-302, 382-422).
- ``pipeline_apply`` with gradients, and dp x pp, against mxtpu's: rtol
  1e-4 / atol 1e-5, gradients atol 2e-4 (tests/test_parallel.py:186-211,
  348-379, 461-510).
- ``DataParallelTrainer`` with ``shard_update`` on and off against
  mxtpu's from the same weights: rtol 2e-4 / atol 2e-5 (tests/
  test_parallel.py:425-458); ``shard_params`` and a ``model`` axis
  training as the 1-D mesh does, rmsprop refused
  (tests/test_torch_mesh_tp.py holds ``shard_params`` to mxtpu's).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxtpu as mx
from mxtpu import parallel as jpar


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return torch, mxtpu_torch


def _cpus(mt, n):
    return [mt.cpu(i) for i in range(n)]


def _t(torch, a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------- collectives
def test_reduce_scatter_and_all_gather(tt):
    torch, _ = tt
    from mxtpu_torch.ops import collective as C
    rng = np.random.RandomState(0)
    xs = [rng.randn(4, 6).astype(np.float32) for _ in range(4)]
    outs = [torch.empty(6) for _ in range(4)]
    C.reduce_scatter_replicas([torch.from_numpy(x) for x in xs], outs)
    total = xs[0] + xs[1] + xs[2] + xs[3]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), total[r])
    gathered = [torch.empty(4, 6) for _ in range(4)]
    C.all_gather_replicas(outs, gathered)
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), total)
    with pytest.raises(Exception, match="reduce_scatter"):
        C.reduce_scatter_replicas([torch.zeros(5)] * 2, [torch.zeros(2)] * 2)
    with pytest.raises(Exception, match="all_gather"):
        C.all_gather_replicas([torch.zeros(2)] * 2, [torch.zeros(5)] * 2)


def test_ppermute_and_all_to_all(tt):
    torch, _ = tt
    from mxtpu_torch.ops import collective as C
    xs = [torch.full((4, 2), float(i)) for i in range(4)]
    got = C.ppermute(xs, [(0, 1), (1, 2), (2, 3)])
    assert [float(g[0, 0]) for g in got] == [0.0, 0.0, 1.0, 2.0]
    assert all(g is not x for g, x in zip(got, xs))
    with pytest.raises(Exception, match="receives twice"):
        C.ppermute(xs, [(0, 1), (2, 1)])
    vals = [torch.arange(8.0).reshape(4, 2) + 10 * i for i in range(4)]
    out = C.all_to_all(vals, 0, 1)
    for j, o in enumerate(out):
        want = np.concatenate([v.numpy()[j:j + 1] for v in vals], axis=1)
        np.testing.assert_array_equal(o.numpy(), want)


def test_collective_gradients_are_the_transposed_collectives(tt):
    torch, _ = tt
    from mxtpu_torch.ops import collective as C
    rng = np.random.RandomState(1)
    xs = tuple(torch.tensor(rng.randn(4, 3), requires_grad=True)
               for _ in range(4))
    perm = [(i, (i + 1) % 4) for i in range(4)]
    assert torch.autograd.gradcheck(lambda *a: C.PPermute.apply(perm, *a),
                                    xs)
    assert torch.autograd.gradcheck(lambda *a: C.AllToAll.apply(0, 1, *a),
                                    xs)


# ---------------------------------------------------------------- mesh
def test_make_mesh_and_mesh_put(tt):
    torch, mt = tt
    from mxtpu_torch.parallel.mesh import mesh_put
    from mxtpu.parallel.mesh import mesh_put as jmesh_put
    from jax.sharding import PartitionSpec as P
    cpus = _cpus(mt, 8)
    m = mt.parallel.make_mesh(devices=cpus)
    assert m.axis_names == ("data",) and m.size == 8
    m2 = mt.parallel.make_mesh((4, 2), devices=cpus)
    assert m2.axis_names == ("data", "model") and m2.shape == \
        {"data": 4, "model": 2}
    assert mt.parallel.current_mesh() is m2
    jm2 = jpar.make_mesh((4, 2))
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for spec in ((), ("data",), (None, "model"), ("data", "model"),
                 (("data", "model"),)):
        got = mesh_put(m2, torch.from_numpy(x), spec)
        want = jmesh_put(jm2, x, P(*spec))
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in want.addressable_shards}
        for i, g in enumerate(got):
            np.testing.assert_array_equal(g.numpy(), by_dev[i],
                                          err_msg=str(spec))
    with pytest.raises(mt.MXNetError, match="named twice|twice"):
        mt.parallel.make_mesh(devices=[mt.cpu(0), mt.cpu(0)])
    assert mt.parallel.process_index() == 0
    assert mt.parallel.process_count() == 1
    mt.parallel.host_barrier()


# ---------------------------------------------------------------- attention
B, T, H, D = 1, 32, 4, 8


def _qkvw(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype("f4") for _ in range(4)]


def _jax_fwd_grads(fn, arrays):
    """mxtpu's output and gradients of sum(out * w), in one jitted
    program."""
    q, k, v, w = (jnp.asarray(a) for a in arrays)

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * w), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_fwd_grads(torch, fn, arrays):
    q, k, v = (_t(torch, a, grad=True) for a in arrays[:3])
    out = fn(q, k, v)
    grads = torch.autograd.grad((out * _t(torch, arrays[3])).sum(),
                                (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, fwd_atol=1e-4, grad_atol=2e-3):
    np.testing.assert_allclose(got[0], want[0], atol=fwd_atol, rtol=0)
    for g, w, nm in zip(got[1], want[1], "qkv"):
        np.testing.assert_allclose(g, w, atol=grad_atol, rtol=0,
                                   err_msg="d%s" % nm)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_mxtpu(tt, causal):
    torch, mt = tt
    arrays = _qkvw(0)
    want = _jax_fwd_grads(lambda q, k, v: jpar.blockwise_attention(
        q, k, v, block_size=16, causal=causal), arrays)
    got = _torch_fwd_grads(torch, lambda q, k, v:
                           mt.parallel.blockwise_attention(
                               q, k, v, block_size=16, causal=causal), arrays)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_mxtpu(tt, causal):
    """The ring over a (1, 4) ('data', 'seq') mesh: output and gradients
    against mxtpu's shard_map ring."""
    torch, mt = tt
    arrays = _qkvw(3)
    jm = jpar.make_mesh((1, 4), ("data", "seq"),
                        devices=jax.devices()[:4])
    tm = mt.parallel.make_mesh((1, 4), ("data", "seq"),
                               devices=_cpus(mt, 4))
    want = _jax_fwd_grads(lambda q, k, v: jpar.ring_attention(
        q, k, v, mesh=jm, axis_name="seq", causal=causal), arrays)
    got = _torch_fwd_grads(torch, lambda q, k, v: mt.parallel.ring_attention(
        q, k, v, mesh=tm, axis_name="seq", causal=causal), arrays)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_mxtpu(tt, causal):
    torch, mt = tt
    arrays = _qkvw(5)
    jm = jpar.make_mesh((4,), ("seq",), devices=jax.devices()[:4])
    tm = mt.parallel.make_mesh((4,), ("seq",), devices=_cpus(mt, 4))
    want = _jax_fwd_grads(lambda q, k, v: jpar.ulysses_attention(
        q, k, v, mesh=jm, causal=causal), arrays)
    got = _torch_fwd_grads(torch, lambda q, k, v:
                           mt.parallel.ulysses_attention(
                               q, k, v, mesh=tm, causal=causal), arrays)
    _close(got, want)


def test_ring_launches_one_hop_per_live_block(tt, monkeypatch):
    """Causal ring over 4: rank r runs r+1 forward hops (its diagonal one
    causal) and r+1 backward hops; not causal, 4 each."""
    torch, mt = tt
    from mxtpu_torch.ops import attention as att
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = att._flash_forward, att.flash_attention_backward

    def f(q, k, v, causal, scale, want_lse=False):
        calls["fwd"].append(causal)
        return fwd(q, k, v, causal, scale, want_lse=want_lse)

    def b(*a, **kw):
        calls["bwd"].append(kw.get("causal"))
        return bwd(*a, **kw)
    monkeypatch.setattr(att, "_flash_forward", f)
    monkeypatch.setattr(att, "flash_attention_backward", b)
    tm = mt.parallel.make_mesh((4,), ("seq",), devices=_cpus(mt, 4))
    for causal, n in ((True, 10), (False, 16)):
        calls = {"fwd": [], "bwd": []}
        got = _torch_fwd_grads(torch, lambda q, k, v:
                               mt.parallel.ring_attention(
                                   q, k, v, mesh=tm, causal=causal),
                               _qkvw(7))
        assert np.isfinite(got[0]).all()
        assert len(calls["fwd"]) == n and len(calls["bwd"]) == n
        assert sum(calls["fwd"]) == sum(calls["bwd"]) == \
            (4 if causal else 0)


def test_sequence_parallel_shape_errors(tt):
    torch, mt = tt
    tm = mt.parallel.make_mesh((4,), ("seq",), devices=_cpus(mt, 4))
    q = torch.zeros(1, 30, 4, 8)
    with pytest.raises(mt.MXNetError, match="does not split"):
        mt.parallel.ring_attention(q, q, q, mesh=tm)
    q = torch.zeros(1, 32, 6, 8)
    with pytest.raises(mt.MXNetError, match="divisible"):
        mt.parallel.ulysses_attention(q, q, q, mesh=tm)
    with pytest.raises(mt.MXNetError, match="no axis"):
        mt.parallel.ring_attention(q, q, q, mesh=tm, axis_name="data")


# ---------------------------------------------------------------- moe
def _moe_inputs(seed, tokens, d, n_experts):
    rng = np.random.RandomState(seed)
    return (rng.randn(n_experts, d, d).astype("f4") * 0.3,
            rng.randn(tokens, n_experts).astype("f4"),
            rng.randn(tokens, d).astype("f4"),
            rng.randn(tokens, d).astype("f4"))


def _torch_expert(torch):
    def fn(p, t):  # t (n_local, cap, d), p["w"] (n_local, d, d)
        return torch.tanh(torch.einsum("ecd,edf->ecf", t, p["w"]))
    return fn


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_apply_matches_mxtpu(tt, capacity_factor):
    """Top-1 over 4 expert devices, ample capacity and a capacity that
    drops tokens (they pass through): output and gradients."""
    torch, mt = tt
    W, gate, x, probe = _moe_inputs(0, 32, 16, 8)
    jm = jpar.make_mesh((4,), ("expert",), devices=jax.devices()[:4])
    tm = mt.parallel.make_mesh((4,), ("expert",), devices=_cpus(mt, 4))

    def jloss(W, gate, x):
        out = jpar.moe_apply(lambda p, t: jnp.tanh(t @ p["w"]), {"w": W},
                             gate, x, mesh=jm,
                             capacity_factor=capacity_factor)
        return jnp.sum(out * probe), out
    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(W, gate, x)
    tW, tg, tx = (_t(torch, a, grad=True) for a in (W, gate, x))
    out = mt.parallel.moe_apply(_torch_expert(torch), {"w": tW}, tg, tx,
                                mesh=tm, capacity_factor=capacity_factor)
    grads = torch.autograd.grad((out * _t(torch, probe)).sum(),
                                (tW, tg, tx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    for g, w, nm in zip(grads, jg, ("W", "gate", "x")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4, err_msg=nm)


def test_moe_topk_matches_mxtpu(tt):
    """Top-2 over 4 expert devices: output, aux loss and the gradients
    of out*probe + 0.01*aux wrt W, gates and x."""
    torch, mt = tt
    W, gate, x, probe = _moe_inputs(7, 12, 6, 8)
    jm = jpar.make_mesh((4,), ("expert",), devices=jax.devices()[:4])
    tm = mt.parallel.make_mesh((4,), ("expert",), devices=_cpus(mt, 4))

    def jloss(W, gate, x):
        out, aux = jpar.moe_apply_topk(lambda w, t: jnp.tanh(t @ w), W,
                                       gate, x, k=2, mesh=jm,
                                       capacity_factor=8.0)
        return jnp.sum(out * probe) + 0.01 * aux, (out, aux)
    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(W, gate, x)
    tW, tg, tx = (_t(torch, a, grad=True) for a in (W, gate, x))
    out, aux = mt.parallel.moe_apply_topk(_torch_expert(torch), {"w": tW},
                                          tg, tx, k=2, mesh=tm,
                                          capacity_factor=8.0)
    grads = torch.autograd.grad((out * _t(torch, probe)).sum()
                                + 0.01 * aux, (tW, tg, tx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    for g, w, nm in zip(grads, jg, ("W", "gate", "x")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4, err_msg=nm)


def test_moe_topk_capacity_drops(tt):
    """mxtpu's test_moe_topk_capacity_drops: capacity 1, every token
    prefers expert 0 then 1; token 0 is routed (zeros), the last passes
    through; the same as mxtpu's output."""
    torch, mt = tt
    tokens, d = 8, 4
    gate = np.tile(np.asarray([[4.0, 2.0]], "f4"), (tokens, 1))
    x = np.random.RandomState(1).randn(tokens, d).astype("f4")
    W = np.zeros((2, d, d), "f4")
    jm = jpar.make_mesh((2,), ("expert",), devices=jax.devices()[:2])
    jout, _ = jax.jit(lambda W, g, x: jpar.moe_apply_topk(
        lambda w, t: t @ w, W, g, x, k=2, mesh=jm,
        capacity_factor=1.0 / 8))(jnp.asarray(W), jnp.asarray(gate),
                                  jnp.asarray(x))
    tm = mt.parallel.make_mesh((2,), ("expert",), devices=_cpus(mt, 2))
    out, _ = mt.parallel.moe_apply_topk(
        lambda p, t: torch.einsum("ecd,edf->ecf", t, p["w"]),
        {"w": _t(torch, W)}, _t(torch, gate), _t(torch, x), k=2, mesh=tm,
        capacity_factor=1.0 / 8)
    out = out.numpy()
    np.testing.assert_allclose(out[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[-1], x[-1], rtol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-6, atol=1e-6)


def test_load_balancing_loss_matches_mxtpu(tt):
    torch, mt = tt
    rng = np.random.RandomState(2)
    gate = rng.randn(3, 10, 8).astype("f4")
    choice = rng.randint(0, 8, (3, 10))
    onehot = np.eye(8, dtype="f4")[choice]
    want = jpar.load_balancing_loss(jnp.asarray(gate), jnp.asarray(onehot))
    got = mt.parallel.load_balancing_loss(_t(torch, gate),
                                          _t(torch, onehot))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_expert_count_must_split(tt):
    torch, mt = tt
    tm = mt.parallel.make_mesh((4,), ("expert",), devices=_cpus(mt, 4))
    with pytest.raises(mt.MXNetError, match="do not split"):
        mt.parallel.moe_apply(None, {"w": torch.zeros(6, 2, 2)},
                              torch.zeros(4, 6), torch.zeros(4, 2), mesh=tm)


# ---------------------------------------------------------------- pipeline
def test_pipeline_matches_mxtpu_with_gradients(tt):
    """4 stages, 4 microbatches of 2: output, dx and dW against mxtpu's
    tick schedule (and the serial chain)."""
    torch, mt = tt
    rng = np.random.RandomState(5)
    Ws = [rng.randn(6, 6).astype("f4") * 0.4 for _ in range(4)]
    x = rng.randn(8, 6).astype("f4")
    probe = rng.randn(8, 6).astype("f4")
    jm = jpar.make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
    jst = jpar.stack_stage_params([{"w": jnp.asarray(w)} for w in Ws])

    def jloss(st, x):
        out = jpar.pipeline_apply(lambda p, t: jnp.tanh(t @ p["w"]), st, x,
                                  mesh=jm, num_microbatches=4)
        return jnp.sum(out * probe), out
    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jst, jnp.asarray(x))
    tm = mt.parallel.make_mesh((4,), ("pipe",), devices=_cpus(mt, 4))
    tst = mt.parallel.stack_stage_params([{"w": _t(torch, w)} for w in Ws])
    tst["w"].requires_grad_(True)
    tx = _t(torch, x, grad=True)
    out = mt.parallel.pipeline_apply(lambda p, t: torch.tanh(t @ p["w"]),
                                     tst, tx, mesh=tm, num_microbatches=4)
    gp, gx = torch.autograd.grad((out * _t(torch, probe)).sum(),
                                 (tst["w"], tx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=2e-4)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp["w"]), atol=2e-4)
    h = x
    for w in Ws:
        h = np.tanh(h @ w)
    np.testing.assert_allclose(out.detach().numpy(), h, rtol=1e-4,
                               atol=1e-5)


def test_composed_dp_pp_matches_mxtpu_and_trains(tt):
    """dp x pp on a ('data', 'pipe') 2 x 4 mesh: the same output as
    mxtpu's, and SGD through the composed pipeline lowers the loss."""
    torch, mt = tt
    rng = np.random.RandomState(1)
    Ws = [rng.randn(8, 8).astype("f4") * 0.4 for _ in range(4)]
    x = rng.randn(16, 8).astype("f4")
    y = rng.randn(16, 8).astype("f4")
    jm = jpar.make_mesh((2, 4), ("data", "pipe"))
    jst = jpar.stack_stage_params([{"w": jnp.asarray(w),
                                    "b": jnp.zeros(8)} for w in Ws])
    jout = jpar.pipeline_apply(lambda p, t: jnp.tanh(t @ p["w"] + p["b"]),
                               jst, jnp.asarray(x), mesh=jm,
                               num_microbatches=2, batch_axis="data")
    tm = mt.parallel.make_mesh((2, 4), ("data", "pipe"),
                               devices=_cpus(mt, 8))
    tst = mt.parallel.stack_stage_params(
        [{"w": _t(torch, w), "b": torch.zeros(8)} for w in Ws])

    def run(st):
        return mt.parallel.pipeline_apply(
            lambda p, t: torch.tanh(t @ p["w"] + p["b"]), st,
            _t(torch, x), mesh=tm, num_microbatches=2, batch_axis="data")
    np.testing.assert_allclose(run(tst).numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    params = {k: v.clone().requires_grad_(True) for k, v in tst.items()}
    losses = []
    for _ in range(6):
        loss = ((run(params) - _t(torch, y)) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.3 * g
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.9, losses
    with pytest.raises(mt.MXNetError, match="microbatches"):
        mt.parallel.pipeline_apply(lambda p, t: t, tst, torch.zeros(6, 8),
                                   mesh=tm, num_microbatches=2,
                                   batch_axis="data")


# ---------------------------------------------------------------- dp
def _dp_net(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=512, name="fc1")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "rescale_grad": 1.0 / 64}),
    ("adam", {"learning_rate": 0.01, "rescale_grad": 1.0 / 64})])
def test_dp_trainer_matches_mxtpu(tt, optimizer, params):
    """3 steps of mxtpu's weight-update-sharding case (fc1 512 rows over
    an 8-way data mesh) from mxtpu's weights, shard_update on and off,
    against mxtpu's trainer; on the host the two port runs agree bit for
    bit, and with shard_update fc1's state is kept by rows."""
    torch, mt = tt
    X = np.random.RandomState(2).randn(64, 16).astype("f4")
    y = np.zeros(64, dtype="f4")
    jmesh = jpar.make_mesh((8,))
    tmesh = mt.parallel.make_mesh((8,), devices=_cpus(mt, 8))
    runs = {}
    for flag in (False, True):
        mx.random.seed(8)
        jtr = jpar.DataParallelTrainer(_dp_net(mx), mesh=jmesh,
                                       optimizer=optimizer,
                                       optimizer_params=params,
                                       shard_update=flag)
        jtr.init({"data": (64, 16), "softmax_label": (64,)})
        w0 = {n: np.asarray(v) for n, v in jtr.params.items()}
        ttr = mt.parallel.DataParallelTrainer(_dp_net(mt), mesh=tmesh,
                                              optimizer=optimizer,
                                              optimizer_params=params,
                                              shard_update=flag)
        ttr.init({"data": (64, 16), "softmax_label": (64,)})
        ttr._module.set_params(mt.convert.params_from_mxtpu(w0, "cpu"), {})
        for _ in range(3):
            jtr.step({"data": X, "softmax_label": y})
            outs = ttr.step({"data": X, "softmax_label": y})
        assert tuple(outs[0].shape) == (64, 4)
        got = {n: v.numpy() for n, v in ttr.params.items()}
        for n, v in jtr.params.items():
            np.testing.assert_allclose(got[n], np.asarray(v), rtol=2e-4,
                                       atol=2e-5, err_msg=(flag, n))
        runs[flag] = got
        fused = ttr.fused
        assert (fused._plan is not None) == flag
        if flag:
            assert fused.sharded_names == ["fc1_weight"]
            assert tuple(fused._plan.opt_spec("fc1_weight")) == ("data",)
            state = fused.opt_state[0]["fc1_weight"]
            first = state[0] if isinstance(state, tuple) else state
            assert first.shape[0] == 512 // 8
    for n in runs[False]:
        np.testing.assert_array_equal(runs[True][n], runs[False][n],
                                      err_msg=n)


def test_trainer_adam_update_is_mxtpus_rule(tt):
    """TrainerAdam off the fused step (``update``, the Updater's and the
    kvstore's path) applies mxtpu's trainer Adam (mxtpu/parallel/dp.py:
    52), 3 updates with wd and rescale: rtol 1e-5 / atol 1e-7 (f32)."""
    torch, mt = tt
    from mxtpu.parallel import dp as jdp
    rng = np.random.RandomState(3)
    w = rng.randn(8, 5).astype("f4")
    grads = [rng.randn(8, 5).astype("f4") for _ in range(3)]
    from mxtpu_torch.parallel.dp import TrainerAdam
    o = TrainerAdam(learning_rate=0.01, wd=0.1, rescale_grad=0.5)
    weight = mt.nd.array(w, ctx=mt.cpu())
    state = o.create_state(0, weight)
    p, m, v = jnp.asarray(w), jnp.zeros_like(w), jnp.zeros_like(w)
    for t, g in enumerate(grads, 1):
        o.update(0, weight, mt.nd.array(g, ctx=mt.cpu()), state)
        p, m, v = jdp._adam(p, jnp.asarray(g), m, v, 0.01, o.beta1,
                            o.beta2, o.epsilon, 0.1, 0.5, t)
    np.testing.assert_allclose(weight.asnumpy(), np.asarray(p), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(state[1].asnumpy(), np.asarray(v),
                               rtol=1e-5, atol=1e-7)


def test_dp_trainer_converges(tt):
    """mxtpu's test_dp_trainer_step_and_convergence through the port."""
    torch, mt = tt
    mt.random.seed(1)
    tr = mt.parallel.DataParallelTrainer(
        _dp_net(mt), mesh=mt.parallel.make_mesh(devices=_cpus(mt, 8)),
        optimizer="sgd", optimizer_params={"learning_rate": 0.5,
                                           "momentum": 0.9,
                                           "rescale_grad": 1.0 / 64},
        shard_update=True)
    tr.init({"data": (64, 16), "softmax_label": (64,)})
    rng = np.random.RandomState(0)
    centers = rng.randn(4, 16) * 3
    cls = rng.randint(0, 4, 512)
    X = (centers[cls] + rng.randn(512, 16)).astype("float32")
    y = cls.astype("float32")
    for _ in range(4):
        for i in range(0, 512, 64):
            tr.step({"data": X[i:i + 64], "softmax_label": y[i:i + 64]})
    outs = tr.step({"data": X[:64], "softmax_label": y[:64]})
    acc = (outs[0].numpy().argmax(axis=1) == y[:64]).mean()
    assert acc > 0.9, acc


def test_dp_trainer_refuses_what_is_not_ported(tt):
    """shard_params and a 'model' axis train now (a 'model' axis that
    splits nothing takes more rows of the batch: the same step as the 1-D
    mesh over the 8 devices); rmsprop stays refused."""
    torch, mt = tt
    cpus = _cpus(mt, 8)
    rng = np.random.RandomState(2)
    X = rng.randn(16, 128).astype("f4")
    y = rng.randint(0, 4, 16).astype("f4")
    params = {"learning_rate": 0.1, "momentum": 0.9}
    got = []
    for mesh, shard in (((4, 2), True), ((4, 2), False), ((8,), False)):
        tr = mt.parallel.DataParallelTrainer(
            _dp_net(mt), mesh=mt.parallel.make_mesh(mesh, devices=cpus),
            optimizer_params=params, shard_params=shard)
        tr.init({"data": (16, 128), "softmax_label": (16,)})
        if shard:  # fc1 (512 x 128 = 2^16 elements) by rows over 'model'
            assert tuple(tr._module._exec_group.execs[0].arg_dict[
                "fc1_weight"].shape) == (256, 128)
        if got:
            tr._module.set_params({k: mt.nd.NDArray(v, mt.cpu())
                                   for k, v in got[0][0].items()}, {})
        w0 = {k: v.clone() for k, v in tr.params.items()}
        for _ in range(2):
            tr.step({"data": X, "softmax_label": y})
        got.append((w0, tr.params))
    for _, w in got[1:]:
        for k in w:
            np.testing.assert_allclose(w[k].numpy(), got[0][1][k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(mt.MXNetError, match="optimizer"):
        mt.parallel.DataParallelTrainer(
            _dp_net(mt), mesh=mt.parallel.make_mesh(devices=cpus),
            optimizer="rmsprop")
    assert mt.parallel.shard_params_spec(
        {"w": (1024, 128), "b": (1024,)},
        mt.parallel.make_mesh((4, 2), devices=cpus)) == \
        {"w": ("model", None), "b": ()}
