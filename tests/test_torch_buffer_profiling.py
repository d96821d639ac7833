"""The port's ``DeviceBuffer`` and ``profiling`` on ``device="cpu"``, case
for case with ``tests/test_common.py::TestDeviceBuffer`` and
``tests/test_profiling.py``, plus what differs: the card is the default
device, the port's kernels are invisible to the FLOP counter.  The span
recorder is tested in ``tests/test_torch_spans.py``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import DeviceBuffer, profiling  # noqa: E402
from tpu_spmv_torch.buffer import buffer_status  # noqa: E402
from tpu_spmv_torch.errors import (DeviceAllocError,  # noqa: E402
                                   InvalidArgumentError, SpMVError)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import RandomGenerator  # noqa: E402

CPU = "cpu"


class TestDeviceBuffer:
    # reference test_common.cpp:21-98 (CudaBuffer semantics)
    def test_alloc_and_size(self):
        buf = DeviceBuffer(100, device=CPU)
        assert buf.size == 100 and len(buf) == 100
        assert not buf.empty
        assert buffer_status(buf) == SpMVError.SUCCESS

    def test_empty(self):
        buf = DeviceBuffer(0, device=CPU)
        assert buf.empty
        assert buffer_status(buf) == SpMVError.INVALID_ARGUMENT
        with pytest.raises(InvalidArgumentError):
            buf.get()

    def test_roundtrip(self):
        buf = DeviceBuffer(64, device=CPU)
        data = np.arange(64, dtype=np.float32)
        buf.copy_from_host(data)
        np.testing.assert_array_equal(buf.copy_to_host(), data)

    def test_copy_overflow_raises(self):
        # cuda_buffer.h:62-63 throws on copy-size overflow
        buf = DeviceBuffer(4, device=CPU)
        with pytest.raises(InvalidArgumentError):
            buf.copy_from_host(np.zeros(8, np.float32))
        with pytest.raises(InvalidArgumentError):
            buf.copy_to_host(count=8)
        with pytest.raises(InvalidArgumentError):
            buf.copy_to_host(out=np.zeros(2, np.float32))

    def test_resize_drops_contents(self):
        buf = DeviceBuffer(8, device=CPU)
        buf.copy_from_host(np.ones(8, np.float32))
        buf.resize(16)
        assert buf.size == 16
        np.testing.assert_array_equal(buf.copy_to_host(),
                                      np.zeros(16, np.float32))

    def test_release(self):
        buf = DeviceBuffer(8, device=CPU)
        buf.release()
        assert buf.empty

    def test_take_moves_ownership(self):
        # move semantics analog (cuda_buffer.h:38-53)
        buf = DeviceBuffer(8, device=CPU)
        t = buf.take()
        assert t.shape == (8,) and t.device == torch.device(CPU)
        assert buf.empty

    def test_swap(self):
        a = DeviceBuffer(4, device=CPU)
        b = DeviceBuffer(8, device=CPU)
        a.swap(b)
        assert a.size == 8 and b.size == 4

    def test_partial_copy(self):
        buf = DeviceBuffer(8, device=CPU)
        buf.copy_from_host(np.ones(4, np.float32), count=4)
        out = buf.copy_to_host()
        np.testing.assert_array_equal(out[:4], np.ones(4, np.float32))
        np.testing.assert_array_equal(out[4:], np.zeros(4, np.float32))
        into = np.full(8, 7.0, np.float32)
        assert buf.copy_to_host(out=into, count=2) is into
        np.testing.assert_array_equal(into[:3], [1.0, 1.0, 7.0])

    def test_dtype(self):
        buf = DeviceBuffer(4, dtype=np.int32, device=CPU)
        assert buf.dtype == torch.int32
        assert buf.get().dtype == torch.int32
        assert DeviceBuffer(4, dtype=torch.int32, device=CPU).dtype \
            == torch.int32

    def test_put_and_repr(self):
        buf = DeviceBuffer(device=CPU)
        buf.put(torch.arange(3, dtype=torch.float32))
        assert buf.size == 3
        with pytest.raises(InvalidArgumentError):
            buf.put(torch.arange(3))
        assert repr(buf) == ("DeviceBuffer(size=3, dtype=torch.float32, "
                             "device=cpu)")
        with pytest.raises(InvalidArgumentError):
            DeviceBuffer(-1, device=CPU)

    def test_default_device_is_the_card(self, monkeypatch):
        """No device named and no card: the reference's first allocation's
        code, never a silent CPU buffer."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceAllocError):
            DeviceBuffer(4)


def test_cost_analysis_reports_flops():
    costs = profiling.cost_analysis(lambda a, b: a @ b, torch.ones(64, 64),
                                    torch.ones(64, 64))
    assert isinstance(costs, dict)
    assert costs["flops"] == 2 * 64 ** 3


def test_cost_analysis_cannot_see_the_ports_kernels():
    """An SpMV through the port's plans dispatches no matrix product: the
    counter sees no FLOPs in it (the docstring says so)."""
    A = RandomGenerator(42).power_law_csr(256, 256, 6.0, 1.6)
    plan = twe.plan_from_host(tplan.build(A), CPU)
    x = torch.ones(256)
    assert profiling.cost_analysis(twe.spmv_window_ell, plan, x)["flops"] \
        == 0.0


def test_memory_analysis_reports_sizes():
    mem = profiling.memory_analysis(lambda a: a * 2.0, torch.ones(128))
    assert isinstance(mem, dict)
    assert mem["argument_size_in_bytes"] == mem["output_size_in_bytes"] \
        == 512
    if not torch.cuda.is_available():
        assert mem["temp_size_in_bytes"] is None


def test_annotate_and_trace_contexts(tmp_path):
    with profiling.annotate("unit-test-region"):
        pass
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.annotate("spmv-region"):
            torch.ones(8).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "spmv-region" in names
