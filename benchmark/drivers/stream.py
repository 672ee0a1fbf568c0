"""Streaming serving through ``runtime.StreamingSession.process``.

``streams`` videos run side by side in one session (one batch row each), in
a closed loop: each call copies one ``chunk_frames`` chunk of every stream
(uint8, made from the seed at set-up in pinned host memory) to the card,
normalises it there, runs ``session.process`` and copies the pooled
features back to the host. After ``video_chunks`` chunks the videos end:
the session is reset (inside the next call) and new videos start, so the
first chunk's shape (with CLS) recurs beside the carried-state shape.
Video ``c`` plays the pool's chunks from chunk ``c`` on, wrapping around.

Checked: every stream's pooled features at the first ``checked_chunks``
chunks of video ``c*`` (drawn from the seed among the first
``checked_cycles``), and every Block's (conv_state, ssm_state) after them,
against the plain reference run over the same frames from a zero state.
"""

from __future__ import annotations

import time
from typing import List

import torch

from benchmark import compare, program, seeds, weights
from benchmark import trace as tracing
from benchmark.harness import Phases, Window


class Driver:
    # The range around each call into the program, and the ranges that name
    # an idle gap in the traced window.
    RANGE = "process"
    LABELS = ("copy_in", "process", "features_to_host")

    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.config, run.traffic
        self.device = torch.device(run.device)
        m = self.mix
        self.streams, self.frames = m["streams"], m["chunk_frames"]
        self.chunks = m["video_chunks"]
        self.tokens_per_frame = (self.cfg["img_size"] // self.cfg["patch_size"]) ** 2
        self.t_tokens = self.frames // self.cfg["tubelet_size"]
        self.checked = (int(seeds.numpy_rng(run.seed, "checked video").integers(m["checked_cycles"])),
                        m["checked_chunks"])
        self.features = {}
        self.snapshot = None
        self.attempted = 0
        self.calls = 0  # calls into the program, warm-up included

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from videomamba_tpu_torch.runtime import StreamingSession

        clock = Phases()
        w = weights.make(self.cfg, self.run.seed, self.device)
        clock.mark("weights")
        self.model = program.build_model(self.cfg, w, self.mix["pool_type"]).eval()
        del w
        program.cast_for_serving(self.model, self.cfg)
        clock.mark("model")
        state_dtype = program.DTYPES[self.mix["state_dtype"]]
        self.session = StreamingSession(self.model, batch_size=self.streams, dtype=state_dtype)
        self.make_inputs()
        clock.mark("inputs")
        if self.run.trace:
            tracing.instrument(program.kernel_library())
        for k in range(2):  # both shapes: the first chunk (CLS) and a carried one
            self._call(0, k)
        clock.mark("warm-up")
        clock.log()
        self.position = 0  # the window starts a new set of videos

    def make_inputs(self) -> None:
        """The frame pool, (video_chunks, streams, 3, chunk_frames, H, W)
        uint8 in host memory (pinned with a card), each chunk drawn on the
        device from its own generator; and the normalisation's constants."""
        shape = (self.streams, 3, self.frames, self.mix["height"], self.mix["width"])
        on_card = self.device.type == "cuda"
        self.pool = torch.empty((self.chunks,) + shape, dtype=torch.uint8, pin_memory=on_card)
        for k in range(self.chunks):
            g = seeds.torch_generator(self.run.seed, "frames", self.device, k)
            self.pool[k].copy_(torch.randint(0, 256, shape, generator=g, device=self.device,
                                             dtype=torch.uint8))
        view = (1, 3, 1, 1, 1)
        self.mean = torch.tensor(self.mix["mean"], device=self.device).view(view)
        self.std = torch.tensor(self.mix["std"], device=self.device).view(view)

    def normalise(self, frames: torch.Tensor) -> torch.Tensor:
        return (frames.float() / 255.0 - self.mean) / self.std

    # ------------------------------------------------------------- calls
    def _call(self, video: int, k: int) -> dict:
        """One chunk of every stream: chunk ``k`` of video ``video``."""
        self.calls += 1
        t_start = time.perf_counter()
        with tracing.label("copy_in"):
            frames = self.pool[(video + k) % self.chunks].to(self.device, non_blocking=True)
            x = self.normalise(frames)
        with tracing.label("process"):
            if k == 0 and self.session.offset != 0:
                self.session.reset()
            _, pooled = self.session.process(x)
        with tracing.label("features_to_host"):
            feats = pooled.float().cpu()
        t_end = time.perf_counter()
        block_tokens = self.t_tokens * self.tokens_per_frame + (1 if k == 0 else 0)
        return dict(start=t_start, end=t_end, frames=self.streams * self.frames,
                    batch=self.streams, block_tokens=block_tokens,
                    patch_tokens=self.t_tokens * self.tokens_per_frame, features=feats)

    def _next(self) -> dict:
        video, k = divmod(self.position, self.chunks)
        rec = self._call(video, k)
        self.position += 1
        if (video, k) == (self.checked[0], self.checked[1] - 1):
            self.snapshot = [(c.detach().clone(), s.detach().clone()) for c, s in self.session.state]
        if video == self.checked[0] and k < self.checked[1]:
            self.features[k] = rec["features"]
        rec.pop("features")
        return rec

    # ------------------------------------------------------------ window
    def measure(self, seconds: float) -> Window:
        records = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            records.append(self._next())
        window = Window("stream", t0, records, self.RANGE)
        self.attempted = len(records)
        while self.snapshot is None:  # the checked video's chunks, late but due
            self._next()
        return window

    def traced(self):
        """A whole video (``traced_chunks`` calls from a reset) under the
        profiler, after one discarded profiled call."""
        self.position = (self.position // self.chunks + 1) * self.chunks
        tracing.warm_profiler(self._next)
        self.position = (self.position // self.chunks + 1) * self.chunks
        records: List[dict] = []
        t0 = time.perf_counter()
        tr = tracing.capture(lambda: records.extend(
            self._next() for _ in range(self.mix["traced_chunks"])), self.LABELS)
        return tr, Window("stream", t0, records, self.RANGE)

    def outcome(self):
        """(calls in the window, calls that failed): a call that raises ends the run."""
        return self.attempted, 0

    def release(self) -> None:
        del self.session, self.model
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_outputs(self, precision: str = "fp32"):
        """The reference's pooled features of the checked chunks and its
        state after them."""
        ref = self.run.reference
        video, count = self.checked
        with ref.no_tf32(), torch.no_grad():
            w = weights.make(self.cfg, self.run.seed, self.device)
            state = ref.zero_state(w, self.cfg, self.streams, self.device)
            prod = ref.Products(precision)
            pooled = {}
            for k in range(count):
                x = self.normalise(self.pool[(video + k) % self.chunks].to(self.device))
                _, p, state = ref.forward(w, self.cfg, x, state, offset=k * self.t_tokens,
                                          prod=prod)
                pooled[k] = p.float().cpu()
        return pooled, state

    def compare(self, pooled, state, want_pooled, want_state) -> dict:
        pool_err = max(compare.rel_err(pooled[k][s], want_pooled[k][s])
                       for k in want_pooled for s in range(self.streams))
        state_err = max(compare.rel_err(got, want)
                        for layer, want_layer in zip(state, want_state)
                        for got, want in zip(layer, want_layer))
        return {"pool_err": pool_err, "state_err": state_err}

    def check(self) -> dict:
        want_pooled, want_state = self.reference_outputs()
        return self.compare(self.features, self.snapshot, want_pooled, want_state)

    def control(self) -> dict:
        """The reference at fp8 products in the program's place (needs only
        :meth:`make_inputs`)."""
        want_pooled, want_state = self.reference_outputs()
        got_pooled, got_state = self.reference_outputs("fp8")
        return self.compare(got_pooled, got_state, want_pooled, want_state)
