"""The port's span and counter recorder (utils/profiling.py span, count,
recording, trace) on the CPU.

- Off (no recording() open) span() is one shared no-op context that reads
  no clock, and count() keeps nothing.
- Nesting: parent is the enclosing span on the same thread, a span on
  another thread is a root there; the counters add up.
- The clock: a span inside a torch.profiler record_function lies within
  that event's kineto start .. start + duration.
- The serving and fold paths: a tiny predict_patients gives serve.request
  around fold.evaluate around eval.batch_in / step.eval / eval.readback, with
  host_syncs 3 a batch; a tiny run_fold gives fold.epoch around fold.plan /
  step.train / fold.loss_readback / fold.evaluate; K1's and K2's wrappers
  give kernel.K1 / kernel.K2.
- trace() writes the block's spans into trace.json on the trace's own
  time base.
"""
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.ops.kernels import build
from multilevel_gnn_tpu_torch.ops.kernels.windowed import build_plan, windowed_spmm
from multilevel_gnn_tpu_torch.train import cli, driver, predict
from multilevel_gnn_tpu_torch.utils import profiling
from multilevel_gnn_tpu_torch.utils.profiling import count, recording, span
from torch_threads import few_threads  # noqa: F401  (autouse)

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
SMALL = dict(node_embedding_dim=4, hidden_channels=8, final_channels=4, head_dim=16,
             conv_channel_list=[8, 16])


def by_name(rec):
    out = {}
    for i, s in enumerate(rec.spans):
        out.setdefault(s.name, []).append(i)
    return out


def inside(rec, i, j):
    """Span i lies within span j in time."""
    a, b = rec.spans[i], rec.spans[j]
    return b.start_ns <= a.start_ns and a.end_ns <= b.end_ns


def ancestors(rec, i):
    out = []
    while rec.spans[i].parent >= 0:
        i = rec.spans[i].parent
        out.append(rec.spans[i].name)
    return out


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with recording off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            count("host_syncs", 5)
    monkeypatch.undo()
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    # and the recording before leaves nothing behind it
    with span("after"):
        count("after")
    assert rec.spans == [] and rec.counts == {}


def test_nesting_and_parents_across_two_threads():
    def worker():
        with span("c"):
            with span("d"):
                count("n", 2)

    with recording() as rec:
        with span("a"):
            with span("b"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                count("n")
        with span("e"):
            pass
    assert not t.is_alive()
    names = by_name(rec)
    (a,), (b,), (c,), (d,), (e,) = (names[k] for k in "abcde")
    s = rec.spans
    assert (s[a].parent, s[b].parent, s[e].parent) == (-1, a, -1)
    assert (s[c].parent, s[d].parent) == (-1, c)
    assert s[a].thread == s[b].thread == s[e].thread != s[c].thread == s[d].thread
    assert s[a].thread == threading.get_native_id()
    assert inside(rec, b, a) and inside(rec, c, b) and inside(rec, d, c)
    assert s[a].end_ns <= s[e].start_ns
    assert rec.counts == {"n": 3}
    assert set(rec.launches) == set(build.REGISTRY)


def test_open_span_closed_at_the_end_and_nested_recordings():
    with span("before"):  # opened with recording off: never recorded
        with recording() as outer:
            with span("a"):
                with recording() as inner:
                    with span("b"):
                        count("k")
                count("k", 2)
            late = span("late")
            late.__enter__()
    late.__exit__(None, None, None)
    assert [s.name for s in inner.spans] == ["b"] and inner.counts == {"k": 1}
    assert [s.name for s in outer.spans] == ["a", "late"] and outer.counts == {"k": 2}
    assert outer.spans[1].start_ns <= outer.spans[1].end_ns
    assert outer.spans[0].parent == outer.spans[1].parent == -1


def test_span_lies_within_its_record_function_event():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as rec:
            for _ in range(3):
                with record_function("outer_rf"):
                    with span("inner"):
                        torch.ones(64, 64).sum()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer_rf"]
    assert len(events) == 3 == len(rec.spans)
    for e, s in zip(sorted(events, key=lambda e: e.start_ns()), rec.spans):
        assert e.start_ns() <= s.start_ns <= s.end_ns <= e.start_ns() + e.duration_ns()


@pytest.fixture(scope="module")
def fold():
    """A tiny fold of the debug cohort (gbm.yaml at small widths)."""
    cfg = Config.from_yaml(GBM, **SMALL).replace(num_run=1, epochs=2, batch_size=8)
    cohort = cli.make_cohort(cfg, True, None, True)
    tr, va, te = driver.fold_indices(cohort.labels(), cfg, 0)
    fcfg, f, X = driver.fold_setup(cfg, cohort, tr, 0, device="cpu")
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
    model = driver._new_model(fcfg, f.ctx, 5)
    return dict(cfg=fcfg, fold=f, X=X, cohort=cohort, split=(tr, va, te), model=model)


def test_predict_patients_spans(fold):
    c = fold["cohort"]
    rows = fold["split"][2]
    batches = -(-len(rows) // fold["cfg"].batch_size)
    with recording() as rec:
        predict.predict_patients(fold["model"], fold["fold"].ctx, fold["X"], c.Y, c.ages,
                                 rows)
    names = by_name(rec)
    (root,) = names["serve.request"]
    (ev,) = names["fold.evaluate"]
    assert rec.spans[root].parent == -1 and rec.spans[ev].parent == root
    for name in ("eval.batch_in", "step.eval", "eval.readback"):
        assert len(names[name]) == batches, name
        for i in names[name]:
            assert rec.spans[i].parent == ev and inside(rec, i, ev)
    for i in names.get("kernel.K1", []) + names.get("kernel.K2", []):
        assert "step.eval" in ancestors(rec, i)
    assert names.get("kernel.K1"), "the sage layers' SpMMs give K1 spans"
    assert rec.counts == {"host_syncs": 3 * batches}
    # each batch comes in, is stepped, then read back
    order = [rec.spans[i].name for i in sorted(names["eval.batch_in"] + names["step.eval"]
                                               + names["eval.readback"])]
    assert order == ["eval.batch_in", "step.eval", "eval.readback"] * batches


def test_run_fold_spans(fold):
    cfg, c = fold["cfg"], fold["cohort"]
    tr, va, te = fold["split"]
    model = driver._new_model(cfg, fold["fold"].ctx, 6)
    with recording() as rec:
        driver.run_fold(cfg, fold["fold"].ctx, fold["X"], c.Y, c.ages, tr, va, te,
                        fold["fold"].class_weight, [cfg.epochs], model=model)
    names = by_name(rec)
    epochs = names["fold.epoch"]
    assert len(epochs) == cfg.epochs
    assert all(rec.spans[i].parent == -1 for i in epochs)
    steps = len(list(driver.epoch_plan(fold["X"], tr, cfg.batch_size, np.random.RandomState(0),
                                       True, True)))
    want = {"fold.plan": 1, "step.train": steps, "fold.loss_readback": 1, "fold.evaluate": 2}
    for name, n in want.items():
        assert len(names[name]) == n * cfg.epochs, name
        for i in names[name]:
            p = rec.spans[i].parent
            assert p in epochs and inside(rec, i, p), name
    eval_batches = sum(-(-len(ix) // cfg.batch_size) for ix in (va, te))
    assert rec.counts == {"host_syncs": cfg.epochs * (1 + 3 * eval_batches)}
    # within an epoch: the plan, the steps, the loss read-back, then evaluate
    for e in epochs:
        kids = [rec.spans[i].name for i, s in enumerate(rec.spans) if s.parent == e]
        assert kids == (["fold.plan"] + ["step.train"] * steps + ["fold.loss_readback"]
                        + ["fold.evaluate"] * 2), kids


@pytest.mark.parametrize("transpose", [False, True])
def test_kernel_spans_around_each_op_call(transpose):
    rng = np.random.RandomState(0)
    n, e = 300, 2000
    s, d = rng.randint(0, n, e), rng.randint(0, n, e)
    plan = build_plan(s, d, n, Wb=128, nwin=1)
    x = torch.randn(n, 8)
    w = torch.rand(e)
    with recording() as rec:
        with span("caller"):
            out = windowed_spmm(x, w, plan, transpose)
    residual = (plan.tres, plan.res_csc) if transpose else (plan.res,)
    k1 = sum(1 for p in residual if p.nnz)
    assert k1 > 0
    assert [sp.name for sp in rec.spans] == ["caller", "kernel.K2"] + ["kernel.K1"] * k1
    assert all(sp.parent == 0 for sp in rec.spans[1:])
    assert all(v == 0 for v in rec.launches.values())  # no kernel runs on the CPU
    torch.testing.assert_close(out, windowed_spmm(x, w, plan, transpose), rtol=0, atol=0)


def test_trace_writes_the_spans(tmp_path):
    from torch.profiler import record_function

    with profiling.trace(str(tmp_path)):
        with record_function("rf"):
            with span("outer"):
                with span("inner"):
                    torch.ones(32, 32).sum()
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    ev = {e["name"]: e for e in doc["traceEvents"]
          if e.get("cat") == "port_span" or e.get("name") == "rf"}
    rf, outer, inner = ev["rf"], ev["outer"], ev["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert inner["args"]["parent"] == outer["args"]["index"]
    assert outer["tid"] == rf["tid"] == threading.get_native_id()
    eps = 1e-3  # one ns in the trace's microseconds
    assert rf["ts"] - eps <= outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] <= rf["ts"] + rf["dur"] + eps
    # recording ends with the trace
    assert span("x") is span("y")
