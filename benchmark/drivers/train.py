"""Masked pretraining through ``parallel.make_train_step``.

Set-up builds one training step (the model with the seed's fp32 masters,
``torch.optim.AdamW`` over every parameter, ``compute_dtype`` from the
configuration) and drives it through the first ``checked_steps`` steps on
batches whose rows all differ; the window then goes on with the same
object. Each step takes a batch from a pool of ``batch_pool`` batches made
on the card from the seed (clips N(0, 1), targets N(0, 1) for the visible
patch tokens) and a fresh tube mask drawn on the host (NumPy), as a data
loader hands it. At most two steps are in flight: the host issues step
``i + 1`` and then waits for step ``i`` to finish.

Checked against the plain reference, which runs the same first steps in
fp32 from the same weights on the same batches: each step's loss, every
leaf's norm of the first gradient (the program's read from AdamW's first
moment after one step), against the larger of the leaf's and the median
leaf's reference norm and, for every leaf that moves, against its own
alone, and every leaf's norm of its change after the checked steps.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import compare, program, seeds, weights
from benchmark import trace as tracing
from benchmark.harness import Phases, Window


class Driver:
    # The range around each call into the program, and the ranges that name
    # an idle gap in the traced window.
    RANGE = "step"
    LABELS = ("mask", "step", "optimizer", "wait")

    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.config, run.traffic
        self.device = torch.device(run.device)
        m, c = self.mix, self.cfg
        self.batch = m["batch"]
        self.grid = (m["frames"] // c["tubelet_size"], m["height"] // c["patch_size"],
                     m["width"] // c["patch_size"])
        per_frame = self.grid[1] * self.grid[2]
        self.hidden_per_frame = int(m["mask_ratio"] * per_frame)
        self.visible = self.grid[0] * (per_frame - self.hidden_per_frame)
        self.recipe = {k: m[k] for k in ("lr", "weight_decay", "betas", "eps")}
        self.losses: List[torch.Tensor] = []
        self.attempted = 0
        self.calls = 0  # steps issued, the checked ones included

    # ------------------------------------------------------------- feed
    def mask(self, i: int) -> np.ndarray:
        """Step ``i``'s tube mask (True = hidden): one spatial mask a clip,
        the same through time; CLS visible."""
        t, h, w = self.grid
        rng = seeds.numpy_rng(self.run.seed, "mask", i)
        out = np.zeros((self.batch, 1 + t * h * w), dtype=bool)
        for b in range(self.batch):
            frame = np.zeros(h * w, dtype=bool)
            frame[rng.permutation(h * w)[:self.hidden_per_frame]] = True
            out[b, 1:] = np.tile(frame, t)
        return out

    def make_batch(self, j: int):
        """Pool batch ``j``: clips (B, 3, T, H, W) and targets (B, visible, E)."""
        m = self.mix
        g = seeds.torch_generator(self.run.seed, "batch", self.device, j)
        video = torch.randn((self.batch, 3, m["frames"], m["height"], m["width"]), generator=g,
                            device=self.device)
        target = torch.randn((self.batch, self.visible, self.cfg["embed_dim"]), generator=g,
                             device=self.device)
        return video, target

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from videomamba_tpu_torch.parallel.train_step import make_train_step

        clock = Phases()
        w = weights.make(self.cfg, self.run.seed, self.device)
        clock.mark("weights")
        self.model = program.build_model(self.cfg, w)
        del w
        clock.mark("model")
        m = self.mix
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=m["lr"], betas=tuple(m["betas"]),
                                     eps=m["eps"], weight_decay=m["weight_decay"])
        step_opt = self.opt.step

        def labelled_step(*args, **kwargs):
            with tracing.label("optimizer"):
                return step_opt(*args, **kwargs)

        self.opt.step = labelled_step
        self.step = make_train_step(self.model, self.opt,
                                    compute_dtype=program.DTYPES[m["compute_dtype"]])
        self.pool = [self.make_batch(j) for j in range(m["batch_pool"])]
        clock.mark("inputs")
        if self.run.trace:
            tracing.instrument(program.kernel_library())
        names = {id(p): n for n, p in self.model.named_parameters()}
        start = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        b1 = m["betas"][0]
        losses = []
        for i in range(m["checked_steps"]):
            losses.append(self._issue(i)["loss"])
            if i == 0:
                self.first_grad = {names[id(p)]: float(torch.linalg.vector_norm(
                    s["exp_avg"].double()) / (1 - b1)) for p, s in self.opt.state.items()}
        self.checked_losses = [float(v) for v in losses]
        self.change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
                       for n, p in self.model.named_parameters() if p in self.opt.state}
        del start
        clock.mark("checked steps")
        clock.log()
        self.index = m["checked_steps"]

    def _issue(self, i: int):
        self.calls += 1
        with tracing.label("mask"):
            mask = self.mask(i)
        video, target = self.pool[i % len(self.pool)]
        with tracing.label("step"):
            return self.step({"video": video, "mask": mask, "target": target})

    # ------------------------------------------------------------ window
    def _loop(self, until, count=None) -> List[dict]:
        """Steps until ``until()`` says stop (or ``count`` steps), at most
        two in flight; each record's ``end`` is when the host saw it done."""
        on_card = self.device.type == "cuda"
        records, pending = [], []
        n = 0
        while (count is None and not until()) or (count is not None and n < count):
            t_start = time.perf_counter()
            metrics = self._issue(self.index)
            self.index += 1
            n += 1
            self.losses.append(metrics["loss"])
            rec = dict(start=t_start, clips=self.batch, batch=self.batch,
                       block_tokens=self.visible + 1,
                       patch_tokens=self.grid[0] * self.grid[1] * self.grid[2])
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                pending.append((ev, rec))
            else:
                pending.append((None, rec))
            while len(pending) > (1 if on_card else 0):
                self._finish(pending.pop(0), records)
        while pending:
            self._finish(pending.pop(0), records)
        return records

    @staticmethod
    def _finish(item, records) -> None:
        ev, rec = item
        if ev is not None:
            with tracing.label("wait"):
                ev.synchronize()
        rec["end"] = time.perf_counter()
        records.append(rec)

    def measure(self, seconds: float) -> Window:
        t0 = time.perf_counter()
        records = self._loop(lambda: time.perf_counter() - t0 >= seconds)
        self.attempted = len(records)
        return Window("train", t0, records, self.RANGE)

    def traced(self):
        tracing.warm_profiler(lambda: self._loop(None, count=1))
        records: List[dict] = []
        t0 = time.perf_counter()
        tr = tracing.capture(lambda: records.extend(self._loop(None, self.mix["traced_steps"])),
                             self.LABELS)
        return tr, Window("train", t0, records, self.RANGE)

    def outcome(self):
        """(steps in the window, steps whose loss is not finite)."""
        window = self.losses[:self.attempted]
        if not window:
            return 0, 0
        finite = torch.isfinite(torch.stack([v.detach().float() for v in window]))
        return self.attempted, int((~finite).sum())

    def release(self) -> None:
        del self.step, self.opt, self.model, self.pool
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_outputs(self, precision: str = "fp32", rows: int = 0):
        """The reference's checked steps (on the first ``rows`` clips of each
        batch where given)."""
        ref = self.run.reference
        m = self.mix
        rows = rows or self.batch
        with ref.no_tf32():
            w = weights.make(self.cfg, self.run.seed, self.device)
            batches = []
            for i in range(m["checked_steps"]):
                video, target = self.make_batch(i % m["batch_pool"])
                batches.append((video[:rows], self.mask(i)[:rows], target[:rows]))
            return ref.train(w, self.cfg, batches, self.recipe, m["reference_rows"],
                             ref.Products(precision))

    def compare(self, losses, first_grad: Dict[str, float], change: Dict[str, float],
                want) -> dict:
        want_losses, want_grad, want_change = want
        loss_err = max(abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
                       for a, b in zip(losses, want_losses))
        moved = compare.moved_leaves(want_grad)
        return {"loss_err": loss_err,
                "grad_err": compare.worst_leaf_gap(first_grad, want_grad),
                "leaf_grad_err": compare.worst_leaf_gap(first_grad, want_grad, names=moved,
                                                        own=True),
                "change_err": compare.worst_leaf_gap(change, want_change, names=moved)}

    def check(self) -> dict:
        want = self.reference_outputs()
        left_out = sorted(set(want[1]) - compare.moved_leaves(want[1]))
        print(f"benchmark: leaves left out of change_err and leaf_grad_err (reference "
              f"gradient under a thousandth of the median leaf's): {left_out}",
              file=sys.stderr, flush=True)
        return self.compare(self.checked_losses, self.first_grad, self.change, want)

    def make_inputs(self) -> None:
        """Nothing: batches and masks are drawn where they are used."""

    def control(self) -> dict:
        """The reference at fp8 products in the program's place."""
        got = self.reference_outputs("fp8")
        return self.compare(got[0], got[1], got[2], self.reference_outputs())

    def fault(self, kind: str) -> dict:
        """A fault planted in the reference put in the program's place:
        "half_batch" leaves out half of every batch, the mean taken over
        the rest."""
        if kind != "half_batch":
            raise ValueError(f"no fault {kind!r} for a training cell")
        got = self.reference_outputs(rows=self.batch // 2)
        return self.compare(got[0], got[1], got[2], self.reference_outputs())
