"""The yardstick's arithmetic on fixed inputs: rates over all work and
time, tails over every request, byte bounds against a hand count, the
import guard's whole-name comparison and the trace's union of intervals."""
import numpy as np
import pytest
import torch

import tiny  # noqa: F401
from harness import counts, guard, trace
from harness.manifest import Manifest


def reader(name):
    return Manifest().reader(name).read


def test_rates_are_all_work_over_all_time():
    serve = {"kind": "serve", "patients": 64 * 10, "window_s": 2.0,
             "request_s": [0.1] * 9 + [1.1]}
    assert reader("serve_samples_per_s")(serve) == 320.0
    train = {"kind": "train", "samples": 256 * 7, "window_s": 3.5}
    assert reader("train_samples_per_s")(train) == 512.0
    assert reader("serve_samples_per_s")(train) is None


def test_p95_is_of_every_request():
    lat = list(np.linspace(0.001, 0.100, 100))
    rec = {"kind": "serve", "request_s": lat}
    want = float(np.percentile(np.asarray(lat) * 1e3, 95))
    assert reader("serve_request_p95_ms")(rec) == pytest.approx(want)
    assert reader("request_p95_ms.b32")(rec) == pytest.approx(want)
    assert want > 94.0


def test_host_and_idle_shares():
    rec = {"kind": "serve", "request_s": [0.01] * 100, "n_requests": 100, "busy_s": 0.4,
           "window_s": 1.0}
    assert reader("host_ms.serve")(rec) == pytest.approx(6.0)
    assert reader("idle_share.serve")(rec) == pytest.approx(60.0)


def test_k1_bytes_by_hand():
    from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan

    # rows 0 <- {1, 2}, 2 <- {1}; 3 rows, 3 entries, sources {1, 2}
    rows, cols, eids = np.array([0, 0, 2]), np.array([1, 2, 1]), np.array([0, 1, 2])
    plan = CSRPlan.build(rows, cols, eids, 3)
    F = 8
    # sources 2 rows x F x 2 B; out 3 rows x F x 4 B; rowptr 4 x 4 B;
    # (col, w) 3 x 8 B; w once per edge 3 x 4 B
    assert counts.k1_bytes(plan, F, 2, False) == 2 * F * 2 + 3 * F * 4 + 16 + 24 + 12
    # adding into out reads and writes the 2 rows with entries
    assert counts.k1_bytes(plan, F, 2, True) == 2 * F * 2 + 4 * F * 4 + 16 + 24 + 12


def test_model_flops_by_hand():
    conf = {"config": {"batch_size": 2, "node_embedding_dim": 1, "hidden_channels": 1,
                       "final_channels": 1, "num_layers": 2, "pca_dim": 1,
                       "pathway_num": 1, "conv_channel_list": [1], "conv_kernel_list": [1],
                       "pathway_pool_dim": 1, "pca_pool_dim": 1, "head_dim": 1,
                       "use_age": False}}
    f = counts.model_flops(conf, nnz=5, n_nodes=3, pca_rows=4)
    # emb 6; per layer: SpMM 20, lin_r 12, MLP 24; contraction 16; conv
    # 2*2*1*3*1*1 = 12; head_0 2*2*3*1 = 12; head_1 2*2*1*2 = 8
    assert f["eval"] == 6 + 2 * (20 + 12 + 24) + 16 + 12 + 12 + 8
    assert f["train"] == 3 * f["eval"]


def test_guard_compares_whole_top_level_names():
    names = ["multilevel_gnn_tpu_torch", "multilevel_gnn_tpu_torch.ops", "jaxtyping",
             "flaxen", "numpy"]
    assert guard.forbidden_loaded(names) == []
    assert guard.forbidden_loaded(names + ["jax.numpy", "multilevel_gnn_tpu.core"]) == [
        "jax.numpy", "multilevel_gnn_tpu.core"]


def test_busy_is_the_union_of_device_intervals():
    dev = [(0, 10, "a", 1, "kernel"), (5, 10, "b", 2, "kernel"), (30, 5, "c", 3, "kernel")]
    assert trace.busy_ns(dev) == 20
    assert trace.gaps(dev, 0, 40) == [(15, 30), (35, 40)]


def test_roofline_silent_when_launches_differ():
    from harness.roofline import share

    rec = {"kind": "serve", "eval_batches": 2, "bytes_eval": {"K1": 1e9, "K2": 2e9,
                                                              "count_K1": 2, "count_K2": 2},
           "kernels_in": {"eval_step": {"K1": 0.001, "K2": 0.002}},
           "launches": {"segment_spmm_csr": 4, "windowed_tile_spmm": 4}}
    assert share(rec, "eval", "eval_step", 2) == pytest.approx(
        100 * 6e9 / 3.35e12 / 0.003)
    rec["launches"]["segment_spmm_csr"] = 5
    assert share(rec, "eval", "eval_step", 2) is None


def test_weights_from_the_seed():
    from harness import inputs

    shapes = {"a.weight": (3, 4), "a.bias": (3,), "node_embedding": (5, 2)}
    w1 = inputs.make_weights(shapes, 2 ** 33 + 5, "cpu", 6, 2)
    w2 = inputs.make_weights(shapes, 2 ** 33 + 5, "cpu", 6, 2)
    w3 = inputs.make_weights(shapes, 2 ** 33 + 6, "cpu", 6, 2)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert float(w1["a.bias"].abs().max()) == 0.0


class _Event:
    """A kineto event as torch 2.11 gives it: no activity_type()."""

    def __init__(self, name, device, start, dur, corr, thread=1):
        self._n, self._d, self._s, self._du, self._c, self._t = (
            name, device, start, dur, corr, thread)

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._du

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def test_trace_reduction_by_device_and_name():
    events = [
        _Event("eval_step", "CPU", 0, 1000, 0),
        _Event("eval_step", "CUDA", 100, 900, 0),          # the span's device mirror
        _Event("aten::mm", "CPU", 10, 100, 0),
        _Event("cudaLaunchKernel", "CPU", 20, 5, 7),
        _Event("cuLaunchKernelEx", "CPU", 60, 5, 8),        # a driver-API launch
        _Event("sm90_gemm", "CUDA", 100, 200, 7),
        _Event("nvjet_gemm", "CUDA", 400, 100, 8),
        _Event("Optimizer.step#Adam.step", "CUDA", 0, 2000, 0),  # annotation mirror
        _Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 600, 50, 9),
        _Event("cudaMemcpyAsync", "CPU", 500, 5, 9),
    ]
    red = trace.reduce_events(events, {"eval_step"}, 0, 2000)
    assert sorted(d[2] for d in red["device"]) == [
        "Memcpy HtoD (Pageable -> Device)", "nvjet_gemm", "sm90_gemm"]
    assert trace.busy_ns(red["device"]) == 350
    assert red["spans"]["eval_step"].total_ns() == 1000
    k = trace.kernel_time_in(red, "eval_step")
    assert k["dense"] == pytest.approx(300e-9) and k["copy"] == pytest.approx(50e-9)
