"""The port's runtime utilities: ``utils/cancel.py`` (a StopSource stops
``to_table``, ``to_batches`` and ``to_batches_prefetched``),
``Declaration.to_batches_prefetched`` (bounded readahead; the producer's
exceptions reach the consumer; closing the consumer stops the producer and
releases its batches, where the JAX package's producer blocks forever:
ROADMAP C40 (d)), ``utils/tracing.py`` (spans, metrics, the profiler's
trace) and ``utils/config.py`` (its list of environment variables is the
package's own)."""

import json
import re
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest

import arrow_tpu.utils as jutils
import arrow_tpu_torch.utils as tutils
from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                   SourceNodeOptions)
from arrow_tpu_torch.compute.expressions import field, literal
from arrow_tpu_torch.core.batch import batch_from_numpy
from arrow_tpu_torch.utils import config, tracing
from arrow_tpu_torch.utils.cancel import (CancelledError, StopSource,
                                          StopToken)

ROOT = Path(__file__).resolve().parents[1]


class _Source:
    """A plan source of ``n`` batches that counts what it made and can
    fail at batch ``fail_at``; its batches' values are weakly tracked."""

    def __init__(self, n=20, fail_at=None, delay=0.0):
        self.n, self.fail_at, self.delay = n, fail_at, delay
        self.made = 0
        self.live = weakref.WeakSet()
        self.closed = threading.Event()
        self.schema = batch_from_numpy({"x": np.arange(4)},
                                       device="cpu").schema

    def __call__(self):
        try:
            for i in range(self.n):
                if i == self.fail_at:
                    raise ValueError(f"source failed at {i}")
                time.sleep(self.delay)
                self.made += 1
                b = batch_from_numpy({"x": np.arange(4) + 4 * i},
                                     device="cpu")
                self.live.add(b.arrays[0].values)
                yield b
        finally:
            self.closed.set()

    def plan(self, filtered: bool = True):
        source = Declaration("source", SourceNodeOptions(self.schema, self))
        if not filtered:
            return source
        return Declaration.from_sequence([source, Declaration(
            "filter", FilterNodeOptions(field("x") >= literal(0)))])


def test_the_utils_have_the_jax_packages_names():
    for name in ("StopSource", "StopToken", "CancelledError", "build_info",
                 "env_settings", "runtime_info", "metrics", "trace_span"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name


def test_stop_token_raises_with_the_reason():
    src = StopSource()
    tok = src.token()
    assert isinstance(tok, StopToken) and not tok.stop_requested
    tok.raise_if_stopped()
    src.request_stop("because")
    assert tok.stop_requested
    with pytest.raises(CancelledError, match="because"):
        tok.raise_if_stopped()
    assert issubclass(CancelledError, RuntimeError)


def test_stop_source_cancels_to_table_and_to_batches():
    s = _Source()
    stop = StopSource()
    stop.request_stop()
    with pytest.raises(CancelledError, match="plan cancelled"):
        s.plan().to_table(stop_token=stop.token())
    s = _Source()
    stop = StopSource()
    it = s.plan().to_batches(stop_token=stop.token())
    assert len(next(it)) == 4
    stop.request_stop("halt")
    with pytest.raises(CancelledError, match="halt"):
        next(it)
    assert s.closed.wait(5)         # the source's generator was closed
    assert s.made < s.n


def test_prefetched_batches_in_order():
    s = _Source(n=9)
    got = [b.column("x").values[:4].tolist()
           for b in s.plan().to_batches_prefetched(prefetch=3)]
    assert got == [list(range(4 * i, 4 * i + 4)) for i in range(9)]


def test_prefetched_producer_errors_reach_the_consumer():
    s = _Source(n=9, fail_at=5)
    it = s.plan().to_batches_prefetched()
    with pytest.raises(ValueError, match="source failed at 5"):
        for _ in it:
            pass


def test_prefetched_stop_token():
    s = _Source(n=50, delay=0.005)
    stop = StopSource()
    got = []
    with pytest.raises(CancelledError):
        for b in s.plan().to_batches_prefetched(stop_token=stop.token()):
            got.append(b)
            if len(got) == 2:
                stop.request_stop()
    assert 2 <= len(got) < 50 and s.closed.wait(5)


def test_closing_the_consumer_stops_the_producer():
    """C40 (d): the JAX package's producer stays blocked in ``q.put`` with
    its batches; the port's stops at its next put and lets them go."""
    s = _Source(n=1000)
    before = {t.ident for t in threading.enumerate()}
    it = s.plan(filtered=False).to_batches_prefetched(prefetch=2)
    first = next(it)
    time.sleep(0.2)                 # the producer fills the queue, blocks
    made = s.made
    assert made <= 5
    it.close()
    assert s.closed.wait(5)
    assert s.made <= made + 1
    leftover = [t for t in threading.enumerate()
                if t.ident not in before and t.name == "arrow_tpu_prefetch"]
    assert not leftover
    del first
    import gc
    gc.collect()
    assert len(s.live) == 0         # no batch held on to


def test_prefetched_consumer_closed_before_its_first_pull():
    """A generator closed before its first ``next`` starts no producer:
    no ``arrow_tpu_prefetch`` thread is left and the source never ran."""
    s = _Source(n=1000)
    before = {t.ident for t in threading.enumerate()}
    it = s.plan(filtered=False).to_batches_prefetched(prefetch=2)
    time.sleep(0.1)
    it.close()
    leftover = [t for t in threading.enumerate()
                if t.ident not in before and t.name == "arrow_tpu_prefetch"
                and t.is_alive()]
    assert not leftover and s.made == 0


def test_trace_span_and_metrics():
    m = tracing.Metrics()
    m.record("a", 10, 0.5)
    m.record("a", 30, 0.5)
    assert m.snapshot() == {"a": {"calls": 2, "rows": 40, "seconds": 1.0,
                                  "rows_per_sec": 40.0}}
    m.reset()
    assert m.snapshot() == {}
    tracing.metrics.reset()
    with tracing.trace_span("unit:span", rows=7):
        pass
    with tracing.trace_span("unit:no_rows"):
        pass
    snap = tracing.metrics.snapshot()
    assert snap["unit:span"]["rows"] == 7 and "unit:no_rows" not in snap
    s = _Source(n=3)
    t = s.plan().to_table()
    assert t.num_rows == 12
    assert tracing.metrics.snapshot()["plan:filter"]["rows"] == 12


def test_profiler_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("ARROW_TPU_TRACE_DIR", raising=False)
    assert tracing.start_profiler() is None        # no directory: off
    monkeypatch.setenv("ARROW_TPU_TRACE_DIR", str(tmp_path))
    assert tracing.start_profiler() == str(tmp_path)
    assert tracing.start_profiler() is None        # one at a time
    with tracing.trace_span("unit:profiled"):
        _Source(n=2).plan().to_table()
    path = tracing.stop_profiler()
    assert tracing.stop_profiler() is None
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any(e.get("name") == "unit:profiled" for e in events)


def test_config_lists_the_variables_the_package_reads(monkeypatch):
    read = set()
    for f in (ROOT / "arrow_tpu_torch").rglob("*.py"):
        read |= set(re.findall(r"ARROW_TPU_[A-Z0-9_]+", f.read_text()))
    assert set(config.ENV_VARS) == read
    monkeypatch.setenv("ARROW_TPU_SPILL_BYTES", "123")
    monkeypatch.setenv("ARROW_TPU_NOT_A_SETTING", "1")
    assert config.env_settings()["ARROW_TPU_SPILL_BYTES"] == "123"
    assert "ARROW_TPU_NOT_A_SETTING" not in config.env_settings()
    info = config.build_info()
    assert set(info) == {"version", "torch_version", "cuda_version",
                         "native_runtime"}
    assert info["native_runtime"] == "True"
    rt = config.runtime_info()
    assert set(rt) == {"device_type", "num_devices", "device0",
                       "cuda_kernels_built"}
