"""The training job: a user's training loop, dispatched ahead.

Traffic keys: ``batch``, ``pool`` (distinct subjects made from the seed
and kept on the device, used ``batch`` at a time in turn), ``volume``,
``subjects`` (``data.make_pool``'s parameters), ``training_layers`` (None:
every parameter), ``tracked_steps`` (the first steps, the ones the output
check follows) and ``warmup_steps``.

Set-up: import and CUDA initialisation; the port's kernels built or found
in the checkout's build cache; the pool made and uploaded; the weights
drawn from the seed on the device and the model file's model and step
built on them; the tracked and the warm-up steps, through the window's own
call and feed.

The window: the step dispatched again and again on the pool's batches,
with no host synchronisation; losses and counts stay on the device until
one fetch after it. A traced run then times the step's enqueue alone: a
few more steps, each called once the device has finished the one before.

The check, once the program is freed: the reference's first steps from
the same weights on the same batches (:mod:`benchmark.check`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from benchmark import check, weights as weights_mod
from benchmark.data import make_pool
from benchmark.harness import Run

DISPATCH_PROBE_STEPS = 9


class Job(Run):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.batch = int(self.traffic["batch"])
        self.pool = int(self.traffic["pool"])
        self.tracked = int(self.traffic["tracked_steps"])
        if self.pool % self.batch or self.pool < self.tracked * self.batch:
            raise ValueError(f"pool {self.pool} must be a multiple of batch "
                             f"{self.batch} and hold {self.tracked} batches")
        self._ref = None
        self.dispatch_s: List[float] = []

    def feed(self, k: int):
        """Batch ``k``: the pool's subjects in turn, ``batch`` at a time
        (a view, no copy)."""
        s = (k * self.batch) % self.pool
        return self.x[s:s + self.batch], self.labels[s:s + self.batch]

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.init()
            torch.empty(1, device=self.device)
        self._part("import_cuda_s")
        from unetsulc_tpu_torch import kernels

        if self.device.startswith("cuda"):
            kernels.build()
        self._part("kernels_s")
        x, lb = make_pool(self.traffic["subjects"], self.traffic["volume"],
                          self.seed, self.pool)
        self.x = torch.from_numpy(x).to(self.device)
        self.labels = torch.from_numpy(lb).to(self.device)
        self._part("subjects_s")
        shapes = self.ref_mod.param_shapes(self.cfg)
        self.weights = weights_mod.make(shapes, self.seed, self.device)
        self.model, self.state, self.step = self.model_mod.build(
            self.cfg, self.traffic, self.weights, self.device)
        self.route = self.model_mod.route(self.model, self.x[:self.batch])
        self.info["route"] = self.route
        self.frozen = self.frozen_names()
        self._part("model_s")
        self.first_steps()
        for k in range(self.tracked,
                       self.tracked + int(self.traffic["warmup_steps"])):
            self.step(self.state, *self.feed(k))
        self.next_batch = self.tracked + int(self.traffic["warmup_steps"])
        self._part("warmup_s")
        self._setup_done()

    def first_steps(self) -> None:
        """The tracked steps, through the window's call and feed, with what
        the check needs kept: each loss and counts, the first gradient as
        the optimizer got it, every parameter after the last."""
        import torch

        losses, cnts = [], []
        for k in range(self.tracked):
            loss, c = self.step(self.state, *self.feed(k))
            losses.append(loss)
            cnts.append(c)
            if k == 0:
                self.grad1 = {n: b.detach().clone() for n, b in
                              self.model_mod.first_gradient(self.state).items()}
        self.params_after = {n: p.detach().clone()
                             for n, p in self.model.named_parameters()}
        self.first_losses = [float(v) for v in torch.stack(losses).cpu()]
        self.first_counts = [c.cpu() for c in cnts]

    # -- the window ------------------------------------------------------
    def loop(self, deadline: float) -> Dict[str, list]:
        losses, cnts, spans = [], [], []
        k = self.next_batch
        clock = time.time_ns
        while time.perf_counter() < deadline:
            x, lb = self.feed(k)
            s = clock()
            loss, c = self.step(self.state, x, lb)
            spans.append((s, clock()))
            losses.append(loss)
            cnts.append(c)
            k += 1
        self.next_batch = k
        self.steps = len(spans)
        self._out = (losses, cnts)
        return {"step": spans}

    def after_window(self, traced: bool) -> None:
        import torch

        losses, cnts = self._out
        del self._out
        # the one fetch of the window's results
        fetched = torch.stack(losses).cpu() if losses else torch.zeros(0)
        if cnts:
            torch.stack(cnts).sum(0).cpu()
        self.attempted = self.steps * self.batch
        self.failed = int((~torch.isfinite(fetched)).sum()) * self.batch
        if traced:
            self.dispatch_s = self.probe_dispatch(DISPATCH_PROBE_STEPS)

    def probe_dispatch(self, n: int) -> List[float]:
        """Host seconds of ``n`` step calls, each made once the device has
        finished the one before: the enqueue's own cost, which the window
        hides once CUDA's launch queue is full."""
        out = []
        for _ in range(n):
            x, lb = self.feed(self.next_batch)
            self.next_batch += 1
            self.sync()
            t = time.perf_counter()
            self.step(self.state, x, lb)
            out.append(time.perf_counter() - t)
        self.sync()
        return out

    # -- the check -------------------------------------------------------
    def frozen_names(self) -> List[str]:
        layers = self.traffic.get("training_layers")
        if layers is None:
            return []
        on = set(self.model_mod.trainable_names(self.model, layers))
        return [n for n in self.weights if n not in on]

    def free_program(self) -> None:
        import torch

        self.trainable = [n for n in self.weights if n not in self.frozen]
        del self.model, self.state, self.step
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self, quant: Optional[str] = None,
              detail: Optional[dict] = None) -> Dict[str, float]:
        """The numbers of :mod:`benchmark.check` of the program's first
        steps against the reference's (``quant`` puts the reference in
        lower precision in the program's place instead: the control)."""
        batches = [self.feed(k) for k in range(self.tracked)]
        if self._ref is None:
            self._ref = self.ref_mod.train_steps(
                self.weights, batches, self.cfg, self.trainable)
        if quant is None:
            prog = {"losses": self.first_losses, "counts": self.first_counts,
                    "grad1": self.grad1, "params": self.params_after}
        else:
            ctl = self.ref_mod.train_steps(self.weights, batches, self.cfg,
                                           self.trainable, quant)
            params = dict(self.weights)
            params.update(ctl["params"])
            prog = {"losses": ctl["losses"], "counts": ctl["counts"],
                    "grad1": ctl["grad1"], "params": params}
        prog["params0"] = self.weights
        return check.compare(prog, self._ref, batches, self.frozen, detail)

    # -- metrics ---------------------------------------------------------
    def context(self) -> dict:
        ctx = super().context()
        ctx.update(self.model_mod.work(self.cfg, self.traffic, self.route))
        ctx.update({"route": self.route, "batch": self.batch,
                    "steps": self.steps, "dispatch_s": self.dispatch_s})
        return ctx
