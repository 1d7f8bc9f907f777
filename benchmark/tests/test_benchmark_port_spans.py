"""The port's spans over a traced window (harness/port_spans.py, which
probes/span_probe.py reads).

- The idle split: every idle nanosecond goes to the path of the spans that
  cover it, nested spans, spans of two threads and a gap that runs across
  span boundaries included; idle under no span is keyed ''.
- split()'s numbers on a hand-made recording of each kind, and none where
  there is nothing to count over.
- cell.run never opens the port's recorder, traced or not: the recorder's
  cost stays out of every result line."""
import contextlib

import pytest

import tiny
from harness import cell, port_spans
from multilevel_gnn_tpu_torch.utils import profiling
from multilevel_gnn_tpu_torch.utils.profiling import Recording, Span

NEW = {
    "serve": ["batch_in_ms.serve", "readback_ms.serve", "syncs_per_batch.serve",
              "step_idle_ms.serve", "off_step_idle_ms.serve", "launch_host_us.serve"],
    "train": ["epoch_host_ms.train", "evaluate_idle_share.train", "step_idle_ms.train",
              "launch_host_us.train"],
}


def test_idle_split_by_the_spans_over_each_nanosecond():
    spans = [(0, 100, "req"), (10, 60, "step"), (20, 30, "k"),   # one thread
             (40, 50, "k"),                                       # another thread's root
             (200, 300, "req"), (250, 260, "step")]
    gaps = [(5, 25), (45, 70), (95, 210), (255, 400)]
    got = port_spans.idle_by_path(spans, gaps)
    # 5-25: req 5-10, req/step 10-20, req/step/k 20-25; 45-70: the other
    # thread's k 45-50, req/step 50-60, req 60-70; 95-210: req 95-100,
    # none 100-200, req 200-210; 255-400: req/step 255-260, req 260-300,
    # none 300-400
    assert got == {"req": 5 + 10 + 5 + 10 + 40, "req/step": 10 + 10 + 5,
                   "req/step/k": 5 + 5, "": 100 + 100}, got
    assert sum(got.values()) == sum(b - a for a, b in gaps)


def test_idle_split_edges():
    # touching spans, an empty span, no spans, no gaps
    spans = [(0, 10, "a"), (10, 20, "b"), (15, 15, "empty")]
    assert port_spans.idle_by_path(spans, [(0, 20)]) == {"a": 10, "b": 10}
    assert port_spans.idle_by_path([], [(3, 7)]) == {"": 4}
    assert port_spans.idle_by_path(spans, []) == {}
    # two spans of one name on two threads over one gap: both on the path
    assert port_spans.idle_by_path([(0, 10, "k"), (2, 8, "k")], [(0, 10)]) == {
        "k": 4, "k/k": 6}


def snap():
    """Two serve requests of two batches each, one K1 and one K2 call a
    batch; the device idle over what red's device list leaves."""
    spans, counts = [], {"host_syncs": 12}
    for r in range(2):
        t = r * 1000
        spans.append(Span("serve.request", t, t + 900, -1, 1))
        spans.append(Span("fold.evaluate", t + 10, t + 890, len(spans) - 1, 1))
        ev = len(spans) - 1
        for b in range(2):
            u = t + 20 + 400 * b
            spans.append(Span("eval.batch_in", u, u + 50, ev, 1))
            spans.append(Span("step.eval", u + 50, u + 250, ev, 1))
            spans.append(Span("kernel.K1", u + 60, u + 70, len(spans) - 1, 1))
            spans.append(Span("kernel.K2", u + 80, u + 110, len(spans) - 2, 1))
            spans.append(Span("eval.readback", u + 250, u + 350, ev, 1))
    return Recording(spans, counts, {"segment_spmm_csr": 4, "windowed_tile_spmm": 4})


def red(busy):
    return {"device": [(a, b - a, "op", 0, "kernel") for a, b in busy], "t0": 0, "t1": 2000}


def test_serve_split_on_a_hand_made_recording():
    # busy: each step's second half, so each step.eval has 100 ns idle
    busy = [(t + 20 + 400 * b + 150, t + 20 + 400 * b + 250)
            for t in (0, 1000) for b in range(2)]
    got = port_spans.split(port_spans.summarise(snap(), red(busy)), "serve", 2e-6)
    assert sorted(got) == sorted(NEW["serve"])
    assert got["batch_in_ms.serve"] == pytest.approx(2 * 50 / 1e6)
    assert got["readback_ms.serve"] == pytest.approx(2 * 100 / 1e6)
    assert got["syncs_per_batch.serve"] == 3.0
    assert got["step_idle_ms.serve"] == pytest.approx(2 * 100 / 1e6)
    # a request's 900 ns less its two steps' 200 ns each
    assert got["off_step_idle_ms.serve"] == pytest.approx((900 - 400) / 1e6)
    assert got["launch_host_us.serve"] == pytest.approx((10 + 30) / 2 / 1e3)


def test_train_split_on_a_hand_made_recording():
    spans = []
    for e in range(2):
        t = e * 1000
        spans += [Span("fold.epoch", t, t + 1000, -1, 1),
                  Span("fold.plan", t, t + 40, 0, 1),
                  Span("step.train", t + 40, t + 540, 0, 1),
                  Span("kernel.K1", t + 300, t + 320, -1, 2),    # backward's thread
                  Span("fold.loss_readback", t + 540, t + 600, 0, 1),
                  Span("fold.evaluate", t + 600, t + 1000, 0, 1)]
    # busy: the second half of each step and of each evaluate
    busy = [(t + 290, t + 540) for t in (0, 1000)] + [(t + 800, t + 1000) for t in (0, 1000)]
    got = port_spans.split(port_spans.summarise(Recording(spans, {"host_syncs": 2}, {}),
                                                red(busy)), "train", 2000 / 1e9)
    assert sorted(got) == sorted(NEW["train"])
    assert got["epoch_host_ms.train"] == pytest.approx((40 + 60) / 1e6)
    assert got["evaluate_idle_share.train"] == pytest.approx(100 * 400 / 2000)
    assert got["step_idle_ms.train"] == pytest.approx(250 / 1e6)
    assert got["launch_host_us.train"] == pytest.approx(20 / 1e3)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_split_leaves_out_what_has_nothing_to_count_over(kind):
    empty = port_spans.summarise(Recording([], {}, {}), red([(0, 2000)]))
    got = port_spans.split(empty, kind, 2e-6)
    # a window with no spans: only the train window's idle share (0) stays
    assert got == ({"evaluate_idle_share.train": 0.0} if kind == "train" else {})
    assert port_spans.split(empty, "train", 0.0) == {}


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    return tiny.manifest(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["kirc-serve", "kirc-train"])
def test_cell_run_never_opens_the_recorder(man, name, monkeypatch):
    opened = []
    real = profiling.recording

    @contextlib.contextmanager
    def spy():
        opened.append(1)
        with real() as rec:
            yield rec

    monkeypatch.setattr(profiling, "recording", spy)
    for traced in (False, True):
        out = cell.run("tiny-" + name, 5, 0.3, traced, device="cpu", man=man)
        assert out["correct"]
        assert not any(m in out["metrics"] for m in NEW["serve"] + NEW["train"])
    assert opened == []
    assert profiling._RECORDER is None
