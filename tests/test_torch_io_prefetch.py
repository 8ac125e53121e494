"""The port's prefetching iterators on the CPU, twins of mxtpu's tests:

- ``test_io_metric_optim.py::test_prefetching_iter``: a PrefetchingIter
  over an NDArrayIter yields every batch;
- ``test_pipeline.py::test_prefetching_iter_lifecycle``: close() joins
  the producer threads, an exhausted iterator resets, a closed one
  raises, and the context-manager form closes;
- ``test_pipeline.py::test_device_prefetch_hides_slow_producer``: when
  each step outlasts the fetch, every arrival finds its batch staged;
- ``test_faults.py::test_chaos_gate_prefetch_producer_crash_surfaces_at_
  consumer``: a producer's exception surfaces at the consumer within one
  batch and on every use after.

Also: ``fit(device_prefetch=True)`` on cpu() ends with weights bit for
bit those of ``fit`` without it, and a DevicePrefetchIter with the
default device (gpu(0)) raises where there is no CUDA. The staging onto a
card is tested on the card (``test_torch_cuda.py``)."""
import logging
import time

import numpy as np
import pytest


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


class _SlowIter:
    """A DataIter adding a fixed latency to every fetch."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay = delay_s
        self.batch_size = inner.batch_size
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        time.sleep(self._delay)
        return self._inner.next()


class _CrashingIter:
    """An NDArrayIter whose ``fail_at``-th fetch raises."""

    def __init__(self, inner, fail_at):
        self._inner = inner
        self._n = 0
        self._fail_at = fail_at
        self.batch_size = inner.batch_size
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        self._n += 1
        if self._n == self._fail_at:
            raise ValueError("producer boom")
        return self._inner.next()


def _base(mt, n=16, batch=4):
    x = np.random.RandomState(0).randn(n, 3).astype("f4")
    return mt.io.NDArrayIter(x, np.arange(n, dtype="f4"), batch_size=batch)


def test_prefetching_iter(mt):
    it = mt.io.PrefetchingIter(_base(mt))
    labels = []
    for batch in it:
        assert batch.data[0].shape == (4, 3)
        labels += batch.label[0].asnumpy().tolist()
    assert labels == list(range(16))
    it.close()


def test_prefetching_iter_lifecycle(mt):
    it = mt.io.PrefetchingIter(_base(mt))
    assert len(list(it)) == 4
    it.reset()                   # reset after exhaustion
    assert len(list(it)) == 4
    it.close()
    it.close()                   # idempotent
    assert not any(t.is_alive() for t in it.prefetch_threads)
    with pytest.raises(mt.MXNetError):
        it.reset()
    with pytest.raises(mt.MXNetError):
        it.next()
    with mt.io.PrefetchingIter(_base(mt)) as it2:
        assert len(list(it2)) == 4
    assert not any(t.is_alive() for t in it2.prefetch_threads)


def test_device_prefetch_hides_slow_producer(mt):
    """The consumer waits on the producer's ``data_ready`` before each
    ``next()`` (a step that outlasts the fetch, with no timing
    assumption): every arrival, the end-of-data probe included, must find
    its batch staged."""
    it = mt.io.DevicePrefetchIter(_SlowIter(_base(mt, 96), 0.002),
                                  device=mt.cpu())
    n = 0
    while True:
        for e in it.data_ready:
            e.wait(timeout=10)
        try:
            it.next()
        except StopIteration:
            break
        n += 1
    it.close()
    assert n == 24
    assert it.ready_hits == n + 1 and it.ready_waits == 0


def test_prefetch_producer_crash_surfaces_at_consumer(mt):
    it = mt.io.PrefetchingIter(_CrashingIter(_base(mt, 64, 8), fail_at=3))
    try:
        assert it.iter_next()                # batch 1
        assert it.iter_next()                # batch 2
        with pytest.raises(ValueError, match="producer boom"):
            it.iter_next()                   # batch 3: the crash surfaces
        with pytest.raises(ValueError, match="producer boom"):
            next(it)
        with pytest.raises(ValueError, match="producer boom"):
            it.reset()
        for t in it.prefetch_threads:        # the producer really exited
            t.join(timeout=5)
            assert not t.is_alive()
    finally:
        it.close()


def test_device_prefetch_renames_and_passes_cpu_batches_through(mt):
    base = _base(mt)
    it = mt.io.DevicePrefetchIter([base], device=mt.cpu(),
                                  rename_data=[{"data": "x"}],
                                  rename_label=[{"softmax_label": "y"}])
    assert [d.name for d in it.provide_data] == ["x"]
    assert [d.name for d in it.provide_label] == ["y"]
    batch = it.next()
    assert batch.data[0].context == mt.cpu()
    assert not it.host_buffers  # nothing staged on the host side
    it.close()


def test_fit_with_device_prefetch_is_bit_identical_on_cpu(mt):
    """...and fit closes the prefetcher it made: no producer thread is
    left."""
    import threading

    import torch
    rng = np.random.RandomState(0)
    x = rng.rand(64, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    quiet = logging.getLogger("quiet")
    quiet.setLevel(logging.ERROR)
    weights = []
    for prefetch in (False, True):
        np.random.seed(3)
        mod = mt.mod.Module(mt.models.get_lenet(10), context=mt.cpu(),
                            logger=quiet)
        threads = threading.active_count()
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                initializer=mt.init.Xavier(), device_prefetch=prefetch,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        assert threading.active_count() == threads
        weights.append(mod.get_params()[0])
    for k in weights[0]:
        assert torch.equal(weights[0][k]._data, weights[1][k]._data), k


def test_device_prefetch_on_the_default_device_raises_without_cuda(mt):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(mt.MXNetError, match="gpu"):
        mt.io.DevicePrefetchIter(_base(mt))
    with pytest.raises(mt.MXNetError, match="gpu"):
        mt.io.DevicePrefetchIter(_base(mt), device="cuda:0")
