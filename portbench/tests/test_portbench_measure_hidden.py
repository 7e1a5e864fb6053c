"""The ``measure_hidden`` reader on synthetic traces: a measure span that
ends while the chunk's kernels run counts, one that ends after the chunk
(the card idle, or on the measure's own operations) does not, and
without a trace, device operations or measure spans it reads nothing."""

import pytest

from portbench import spec
from portbench.record import Record, Trace

K1 = "void sweep_step_bf16_wide_kernel<1, false, false>(SweepArgs)"
K2 = "void finish_coef_kernel<512, 4>(FinishArgs)"
SUM = "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)"
READ = "Memcpy DtoH (Device -> Pinned)"


def read(spans, ops):
    rec = Record(grid=(4, 4, 4), b_streams=False, setup_s=1.0, window_s=2.0, chunk_steps=0,
                 trace=Trace(window_s=2.0, device_ops=ops, spans=spans))
    return spec.reader("measure_hidden")(rec)


def chunk(t0, steps=3, k1=10e-6, k2=3e-6, gap=1e-6):
    """(name, start, seconds, state) of a chunk's K1/K2 pairs from t0,
    ``gap`` between launches."""
    ops, t = [], t0
    for _ in range(steps):
        ops.append((K1, t, k1, 0))
        t += k1 + gap
        ops.append((K2, t, k2, 0))
        t += k2 + gap
    return ops


def measure_ops(t0):
    return [(SUM, t0, 2e-6, 0), (SUM, t0 + 3e-6, 2e-6, 0), (READ, t0 + 6e-6, 1e-6, 0)]


def test_a_measure_ending_inside_a_sweep_counts():
    ops = chunk(0.0) + measure_ops(60e-6)
    assert read([("wafer.measure", 0.0, 5e-6)], ops) == pytest.approx(100.0)


def test_a_measure_ending_between_two_of_the_chunks_kernels_counts():
    # K1 ends at 10 µs, K2 starts at 11 µs: the chunk still runs
    ops = chunk(0.0) + measure_ops(60e-6)
    assert read([("wafer.measure", 0.0, 10.5e-6)], ops) == pytest.approx(100.0)


def test_a_measure_ending_after_the_chunk_does_not_count():
    ops = chunk(0.0) + measure_ops(60e-6)
    end = ops[5][1] + ops[5][2]  # the chunk's last K2
    gap = [("wafer.measure", 0.0, end + 5e-6)]  # the card idle
    own = [("wafer.measure", 55e-6, 12e-6)]  # its read waited on its own sums
    assert read(gap, ops) == pytest.approx(0.0)
    assert read(own, ops) == pytest.approx(0.0)


def test_the_share_over_every_measure():
    ops = chunk(0.0) + measure_ops(60e-6) + chunk(1e-3) + measure_ops(1.06e-3)
    spans = [("wafer.measure", 0.0, 20e-6), ("wafer.host_read", 0.05e-3, 20e-6),
             ("wafer.measure", 1.05e-3, 20e-6)]  # the second ends on its own ops
    assert read(spans, ops) == pytest.approx(50.0)


def test_nothing_without_a_trace():
    rec = Record(grid=(4, 4, 4), b_streams=False, setup_s=1.0, window_s=2.0, chunk_steps=0)
    assert spec.reader("measure_hidden")(rec) is None


def test_nothing_without_device_operations_or_measure_spans():
    assert read([("wafer.measure", 0.0, 5e-6)], []) is None
    assert read([("wafer.evolve_chunk", 0.0, 5e-6)], chunk(0.0)) is None
    assert read([], chunk(0.0)) is None


def test_the_metric_is_declared_for_both_cells():
    (metric,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == "measure_hidden"]
    assert metric == {"name": "measure_hidden", "unit": "%", "better": "higher",
                      "source": "device_trace", "layer": "measure", "moves": "update_rate",
                      "workloads": [c["name"] for c in spec.benchmark()["workloads"]]}
