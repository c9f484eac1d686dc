"""The port's Prefetcher (``repro_torch/data/pipeline.py``) against JAX's
(``repro/data/pipeline.py``).

* The Prefetcher yields the rounds JAX's Prefetcher yields, in order.
* JAX's Prefetcher hangs after a loader error: its thread catches only
  ``queue.Full``, dies with the error, and ``next()`` would block for
  ever on the empty queue (ROADMAP Queue 3).  The port raises the error
  again in ``next()``.
* The port draws each round once, however long the queue stays full,
  and ``stop()`` joins its thread.
"""
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.data import pipeline as jdata
from repro_torch.data import pipeline as tdata

R, BMB, SEQ, VOCAB = 2, 4, 16, 512


def _jax_loader():
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    sh = NamedSharding(mesh, P())
    specs = {k: jax.ShapeDtypeStruct((R, BMB, SEQ), jnp.int32, sharding=sh)
             for k in ("tokens", "labels")}
    return jdata.ShardedLoader(jdata.SyntheticLM(VOCAB, SEQ, seed=7), specs)


def _port_loader():
    return tdata.Loader(tdata.SyntheticLM(VOCAB, SEQ, seed=7), R, BMB, "cpu")


def test_prefetcher_yields_jax_prefetchers_rounds_in_order():
    jp = jdata.Prefetcher(_jax_loader(), start_step=3, prefetch=2)
    tp = tdata.Prefetcher(_port_loader(), start_step=3, prefetch=2)
    try:
        for _ in range(4):
            want, got = next(jp), next(tp)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    finally:
        jp.stop()
        tp.stop()
    assert not tp._thread.is_alive()


class _FailsAtStep:
    """A loader whose round ``fail_at`` raises; counts its draws."""

    device = torch.device("cpu")

    def __init__(self, fail_at: int):
        self.fail_at, self.draws = fail_at, {}

    def get(self, step):
        self.draws[step] = self.draws.get(step, 0) + 1
        if step == self.fail_at:
            raise ValueError(f"round {step} cannot be read")
        return {"tokens": torch.full((1,), step)}


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_jax_prefetcher_hangs_after_a_loader_error():
    """The fault of the reference, pinned: after the loader raises at
    round 1, JAX's thread is dead and its queue stays empty, so its
    ``next()`` (``self.q.get()`` without a timeout) would block for ever;
    ``q.get(timeout=2)`` raises ``queue.Empty`` in its place."""
    p = jdata.Prefetcher(_FailsAtStep(1), prefetch=2)
    try:
        assert int(next(p)["tokens"][0]) == 0
        p._thread.join(5)
        assert not p._thread.is_alive()
        with pytest.raises(queue.Empty):
            p.q.get(timeout=2)
    finally:
        p.stop()


def test_port_prefetcher_raises_the_loaders_error():
    p = tdata.Prefetcher(_FailsAtStep(1), prefetch=2)
    try:
        assert int(next(p)["tokens"][0]) == 0
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="round 1 cannot be read"):
            next(p)
        assert time.monotonic() - t0 < 5
    finally:
        p.stop()
    assert not p._thread.is_alive()


def test_port_prefetcher_draws_each_round_once():
    """With the queue full for longer than a put's timeout, JAX's thread
    draws the round again; the port's holds the round it drew."""
    loader = _FailsAtStep(fail_at=-1)
    p = tdata.Prefetcher(loader, start_step=5, prefetch=1)
    try:
        time.sleep(0.8)          # the queue is full past a put's timeout
        got = [int(next(p)["tokens"][0]) for _ in range(3)]
    finally:
        p.stop()
    assert got == [5, 6, 7]
    assert all(n == 1 for n in loader.draws.values())
    jax_loader = _FailsAtStep(fail_at=-1)
    jp = jdata.Prefetcher(jax_loader, start_step=5, prefetch=1)
    try:
        time.sleep(0.8)
        assert int(next(jp)["tokens"][0]) == 5
    finally:
        jp.stop()
    assert max(jax_loader.draws.values()) > 1


def test_stop_ends_a_blocked_thread():
    p = tdata.Prefetcher(_port_loader(), prefetch=1)
    time.sleep(0.2)
    t0 = time.monotonic()
    p.stop()
    assert not p._thread.is_alive() and time.monotonic() - t0 < 2


def test_loader_host_rounds_are_the_device_rounds():
    loader = _port_loader()
    host, dev = loader.host(2), loader.get(2)
    for k in host:
        assert torch.equal(host[k], dev[k])
        assert not host[k].is_pinned()
