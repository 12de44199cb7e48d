"""The closed loop that drives the program: one client calling
``repro_torch.api.solve`` one request at a time.

It has ``setup()`` (instances onto the device, every shape the traffic
uses warmed up) and ``window(seconds)`` (the measured loop, which returns
when it closes). A record is kept for every request: its pool index, the
harness clock at submit and at return, the program's answer and any
error.
"""
from __future__ import annotations

import time
import traceback

from torch.profiler import record_function

from ramabench.instances import to_program


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SolveLoop:
    """One client: whole ``api.solve`` calls back to back on the plan's
    instances in turn. The window closes at the first solve boundary at
    or after ``seconds``."""

    def __init__(self, config: dict, plan, device, capture, cost=None):
        self.config, self.plan, self.device = config, plan, device
        self.capture = capture
        self.cost = cost or {}          # index -> replacement costs

    def setup(self):
        from repro_torch import api
        self.api = api
        self.kw = dict(device=self.device, mode=self.plan.mode)
        self.insts = [to_program(h, self.device, self.cost.get(i))
                      for i, h in enumerate(self.plan.host)]
        sync(self.device)
        self.solve(0, note_cycles=False)    # warm-up
        sync(self.device)

    def solve(self, i: int, note_cycles: bool = True):
        if note_cycles:
            self.capture.expect_cycles(self.plan.host[i].num_edges)
        with record_function("bench.solve"):
            res = self.api.solve(self.insts[i], **self.kw)
            sync(self.device)
        return res

    def window(self, seconds: float, clock=time.perf_counter) -> list:
        self.records = []
        n = len(self.plan.host)
        t0 = clock()
        k = 0
        while True:
            i = k % n
            k += 1
            t_s = clock()
            rec = dict(index=i, t_submit=t_s)
            try:
                rec["answer"] = self.solve(i)
            except Exception:           # noqa: BLE001 - the run goes on
                rec["error"] = traceback.format_exc()
            rec["t_done"] = clock()
            rec["cycles"] = self.capture.take_cycles()
            self.records.append(rec)
            if rec["t_done"] - t0 >= seconds:
                break
        self.window_s = self.records[-1]["t_done"] - t0
        return self.records

    def release(self):
        self.insts = None

