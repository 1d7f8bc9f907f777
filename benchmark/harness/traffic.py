"""The one generator of the benchmark's traffic: it reads a mix's data
file (traffic/<name>.json) and drives the port's entry point for it.

kind "serve": a closed loop of `clients` (1) client(s); each request is
one train/predict.py:predict_patients call on `patients` distinct patients
drawn from the seed out of the cohort, with `think_ms` between requests.
kind "fold_train": train/driver.py:run_fold on fold `fold` of the
protocol's stratified splits for E whole epochs, E = ceil(seconds / the
epoch time measured in set-up), at least `min_epochs`.

In a traced run the benchmark's spans wrap the calls into each layer
('request', 'evaluate', 'eval_step', 'train_step'); an untraced run wraps
nothing."""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness import inputs


@contextlib.contextmanager
def patched(module, name: str, wrapper):
    """module.name replaced by wrapper(module.name) inside the block, which
    gets the replacement."""
    real = getattr(module, name)
    setattr(module, name, wrapper(real))
    try:
        yield getattr(module, name)
    finally:
        setattr(module, name, real)


def spanned(span: str, events: List = None):
    """A wrapper factory: the call inside record_function(span), with CUDA
    events around it when ``events`` is a list, and its host seconds
    summed in wrapper.seconds."""
    from torch.profiler import record_function

    def wrap(real):
        def call(*a, **k):
            t0 = time.perf_counter()
            with record_function(span):
                if events is None:
                    out = real(*a, **k)
                else:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    out = real(*a, **k)
                    ev[1].record()
                    events.append(ev)
            call.seconds += time.perf_counter() - t0
            return out
        call.seconds = 0.0
        return call
    return wrap


class Serve:
    def __init__(self, mix: dict, sut: dict, seed: int):
        if mix.get("clients", 1) != 1:
            raise NotImplementedError("one client")
        self.mix, self.sut, self.seed = mix, sut, seed
        rng = inputs.numpy_rng(seed, inputs.REQUESTS)
        P = len(sut["Y"])
        self.requests = [np.sort(rng.choice(P, mix["patients"], replace=False))
                         for _ in range(mix["distinct_requests"])]

    def _call(self, rows):
        from multilevel_gnn_tpu_torch.train.predict import predict_patients

        s = self.sut
        return predict_patients(s["model"], s["ctx"], s["X"], s["Y"], s["ages"], rows)

    def warm(self) -> Dict:
        for rows in self.requests[: self.mix["warm_requests"]]:
            self._call(rows)
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        return {}

    def window(self, seconds: float, traced: bool, max_requests: int = 0) -> Dict:
        """Requests until `seconds` have passed (or, for calibration,
        `max_requests` have been served)."""
        from multilevel_gnn_tpu_torch.train import driver

        think = self.mix.get("think_ms", 0) / 1e3
        lat, served = [], []
        events = [] if traced and torch.cuda.is_available() else None
        request = self._call
        stack = contextlib.ExitStack()
        if traced:
            stack.enter_context(patched(driver, "eval_step", spanned("eval_step", events)))
            stack.enter_context(patched(driver, "evaluate", spanned("evaluate")))
            request = spanned("request")(self._call)
        n = len(self.requests)
        with stack:
            t_start = time.perf_counter()
            i = 0
            while True:
                rows = self.requests[i % n]
                t0 = time.perf_counter()
                res = request(rows)
                t1 = time.perf_counter()
                lat.append(t1 - t0)
                served.append((i % n, res["prob"], res["loss"]))
                i += 1
                if t1 - t_start >= seconds or i == max_requests:
                    break
                if think:
                    time.sleep(think)
            t_end = time.perf_counter()
        rec = {"kind": "serve", "window_s": t_end - t_start, "request_s": lat,
               "n_requests": len(lat), "patients": len(lat) * self.mix["patients"],
               "eval_batches": len(lat) * math.ceil(self.mix["patients"]
                                                    / self.sut["cfg"].batch_size),
               "served": served}
        if events is not None:
            torch.cuda.synchronize()
            rec["eval_batch_ms"] = [a.elapsed_time(b) for a, b in events]
        return rec


class FoldTrain:
    def __init__(self, mix: dict, sut: dict, seed: int):
        self.mix, self.sut, self.seed = mix, sut, seed
        self.split = inputs.fold_split(sut["Y"], sut["conf"]["config"], mix["fold"])
        self.cw = inputs.class_weight(sut["Y"], self.split[0],
                                      sut["conf"]["config"].get("weight_power", 1.0))
        self.epochs = None

    def _run(self, epochs: int):
        from multilevel_gnn_tpu_torch.train import driver

        s = self.sut
        cfg = s["cfg"].replace(epochs=epochs)
        checks = list(range(5, epochs + 1, 5)) or [epochs]
        tr, va, te = self.split
        return driver.run_fold(cfg, s["ctx"], s["X"], s["Y"], s["ages"], tr, va, te,
                               self.cw, checks, model=s["model"])

    def warm(self, seconds: float, capture_steps: int = 3, timing: bool = True) -> Dict:
        """The first run_fold call (one epoch) with the first steps'
        readings taken for the check; then the epoch time, over a second
        call of `timing_epochs`, which sets E."""
        from multilevel_gnn_tpu_torch.train import driver

        names = [n for n, p in self.sut["model"].named_parameters() if p.requires_grad]
        cap = {}

        def spy(real):
            def call(model, optimizer, *a, **k):
                loss = real(model, optimizer, *a, **k)
                step = optimizer.count
                if step == 1:
                    b1 = optimizer.adam.param_groups[0]["betas"][0]
                    cap["grad"] = {n: (optimizer.adam.state[p]["exp_avg"] / (1 - b1)).to("cpu", copy=True)
                                   for n, p in zip(names, optimizer.params)}
                if step == capture_steps:
                    cap["params"] = {n: p.detach().to("cpu", copy=True)
                                     for n, p in zip(names, optimizer.params)}
                return loss
            return call

        with patched(driver, "train_step", spy):
            fr = self._run(1)
        cap["losses"] = fr.step_losses[:capture_steps]
        if not timing:
            return {"capture": cap}
        t0 = time.perf_counter()
        self._run(self.mix["timing_epochs"])
        epoch_s = (time.perf_counter() - t0) / self.mix["timing_epochs"]
        self.epochs = max(self.mix["min_epochs"], math.ceil(seconds / epoch_s))
        return {"capture": cap, "epoch_s": epoch_s, "epochs": self.epochs}

    def window(self, seconds: float, traced: bool) -> Dict:
        from multilevel_gnn_tpu_torch.train import driver

        stack = contextlib.ExitStack()
        if traced:
            stack.enter_context(patched(driver, "train_step", spanned("train_step")))
            evaluate = stack.enter_context(patched(driver, "evaluate", spanned("evaluate")))
        with stack:
            t0 = time.perf_counter()
            fr = self._run(self.epochs)
            t1 = time.perf_counter()
        steps = len(fr.step_ms) if fr.step_ms else len(fr.step_losses)
        B = self.sut["cfg"].batch_size
        n_eval = sum(math.ceil(len(ix) / B) for ix in self.split[1:]) * self.epochs
        q = np.percentile(fr.epoch_times, [25, 50, 75]) if fr.epoch_times else [0, 0, 0]
        rec = {"kind": "train", "window_s": t1 - t0, "epochs": self.epochs,
               "epoch_s_quartiles": [float(v) for v in q],
               "steps": steps, "samples": steps * B, "step_ms": list(fr.step_ms),
               "eval_batches": n_eval}
        if traced:
            rec["evaluate_s"] = evaluate.seconds
        return rec
