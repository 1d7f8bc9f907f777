"""Whole runs of the harness on the CPU at a tiny size, past its look for
a chip: the plain reference agrees with the port; the fp8 control and a
broken timed path come out not correct.

The limits here are the tiny size's own (its bf16 trunk is 4 to 8 wide,
where the port's rounding weighs more than at the cells' widths), set
from eight seeds' readings at this size: above the port's largest
(kirc-serve logit 0.009, loss 1.2e-4; gbm-serve 5.3e-4, 2.0e-4;
kirc-train loss 8.2e-5, grad 0.055, update 0.043).  At this size gbm's
scores are mostly its age input, so its control is held against the
port's reading on the same seed."""
import contextlib
import dataclasses
import json

import pytest
import torch

import tiny
from harness import cell, check

TINY_LIMITS = {
    "kirc-serve": {"logit_gap": 0.02, "loss_gap": 4e-4, "missing": 0},
    "gbm-serve": {"logit_gap": 1e-3, "loss_gap": 4e-4, "missing": 0},
    "kirc-train": {"loss1_gap": 3e-4, "loss_gap": 3e-4, "grad_gap": 0.08,
                   "update_gap": 0.08},
}
SEEDS = (3, 2 ** 32 + 11)


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    return tiny.manifest(tmp_path_factory.mktemp("bench"), limits=TINY_LIMITS)


def run(man, name, seed, traced=False):
    return cell.run("tiny-" + name, seed, 0.3, traced, device="cpu", man=man)


@pytest.mark.parametrize("name", ["kirc-serve", "gbm-serve", "kirc-train"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_agrees_with_reference(man, name, seed):
    out = run(man, name, seed, traced=seed == SEEDS[0])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    json.dumps(out)


@contextlib.contextmanager
def broken(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _half_train(real):
    def call(model, optimizer, batch, *a, **k):
        m = batch.sample_mask.clone()
        m[len(m) // 2:] = False
        return real(model, optimizer, dataclasses.replace(batch, sample_mask=m), *a, **k)
    return call


def _unchanged(real):
    def call(model, optimizer, *a, **k):
        saved = [p.detach().clone() for p in optimizer.params]
        loss = real(model, optimizer, *a, **k)
        with torch.no_grad():
            for p, s in zip(optimizer.params, saved):
                p.copy_(s)
        return loss
    return call


def calibrate():
    import importlib.util

    spec = importlib.util.spec_from_file_location("calibrate", tiny.BENCH / "calibrate.py")
    cal = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cal)
    return cal


CAL = calibrate()


@pytest.mark.parametrize("name,fn,make", [
    ("kirc-serve", "eval_step", CAL.altered),
    ("kirc-serve", "eval_step", CAL.half_mask),
    ("gbm-serve", "eval_step", CAL.altered),
    ("gbm-serve", "eval_step", CAL.half_mask),
    ("kirc-train", "train_step", _half_train),
    ("kirc-train", "train_step", _unchanged),
], ids=["kirc-serve-altered", "kirc-serve-half", "gbm-serve-altered", "gbm-serve-half",
        "kirc-train-half", "kirc-train-unchanged"])
def test_broken_timed_path_is_not_correct(man, name, fn, make):
    from multilevel_gnn_tpu_torch.train import driver

    with broken(driver, fn, make):
        out = run(man, name, SEEDS[0])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["kirc-serve", "gbm-serve", "kirc-train"])
def test_fp8_control_is_not_correct(man, name):
    """The reference in fp8 where the configuration's trunk is bf16, put in
    the program's place, fails the limits (tiny size; on the chip at the
    cells' size: benchmark/calibrate.py, readings in PERF.md)."""
    cal = CAL
    c = man.cell("tiny-" + name)
    dev = torch.device("cpu")
    if name.endswith("serve"):
        r = cal.serve_readings(man, c, SEEDS[0], dev, {}, 8, True, False)
    else:
        r = cal.train_readings(man, c, SEEDS[0], dev, {}, True, False)
    limits = TINY_LIMITS[name]
    assert check.judge(r["program"], limits), r
    if name == "gbm-serve":
        assert r["control"]["logit_gap"] > 3 * r["program"]["logit_gap"], r
    else:
        assert not check.judge(r["control"], limits), r
