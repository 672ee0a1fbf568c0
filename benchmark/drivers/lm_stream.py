"""Long-document prefill through ``runtime.StreamingSession.process`` for the
hybrid language model.

``streams`` token streams run side by side in one session (one batch row
each) whose attention layers hold KV caches of ``chunk_tokens`` x
``document_chunks`` positions, in a closed loop: each call copies one
``chunk_tokens`` chunk of every stream's ids (int64, drawn from the seed
at set-up into pinned host memory) to the card, runs ``session.process``
and copies the last position's logits (fp32) back to the host. After
``document_chunks`` chunks the documents end: the session is reset (inside
the next call) and new documents start. Document ``d`` reads the pool's
document ``d`` modulo ``pool_documents``.

Checked, against the plain reference run over the same ids from nothing:
stream ``s*`` (drawn from the seed) through its whole document ``d*``
(drawn among the first ``checked_cycles`` of the window): its logits after
every chunk (``logit_err``, with every stream's logits after the first
chunk, which catch swapped rows), at the document's end each Mamba-2
layer's conv window and SSM state (``state_err``) and each attention
layer's keys and values (``kv_err``), and each attention mixer's output at
every position of the document's last chunk (``attn_err``: the queries
over the whole cache, which the logits alone hardly see, since with
weights drawn at the init's scales the attention is near uniform).
"""

from __future__ import annotations

import time
from typing import List

import torch

from benchmark import compare, lm, program, seeds
from benchmark import trace as tracing
from benchmark.harness import Phases, Window

# A configuration above this many parameters runs only on the card.
CPU_PARAMETERS = 200_000_000


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``compare.rel_err``'s number, reduced in float64 on the reference's
    device: a check's KV caches hold 537 M elements, which the host takes
    about 10 s to reduce."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.detach().to(want.device, torch.float64), want.detach().double()
    if not torch.isfinite(got).all():
        return float("inf")
    scale, gap = want.abs().max().item(), (got - want).abs().max().item()
    if scale == 0.0:
        return 0.0 if gap == 0.0 else 1.0
    return gap / scale


class Driver:
    RANGE = "process"
    LABELS = ("copy_in", "process", "logits_to_host")

    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.config, run.traffic
        self.device = torch.device(run.device)
        m = self.mix
        self.streams, self.chunk = m["streams"], m["chunk_tokens"]
        self.chunks = m["document_chunks"]
        rng = seeds.numpy_rng(run.seed, "checked document")
        self.checked = (int(rng.integers(m["checked_cycles"])), int(rng.integers(self.streams)))
        self.logits = {}      # chunk -> the checked stream's logits (vocab,)
        self.first = None     # every stream's logits after the checked document's first chunk
        self.snapshot = None  # the checked stream's layer states at the document's end
        self.attention_out = {}  # layer -> the checked stream's attention output, last chunk
        self.attempted = 0
        self.calls = 0  # calls into the program, warm-up included

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from videomamba_tpu_torch.runtime import StreamingSession

        if self.device.type != "cuda" and self.cfg["parameters"] > CPU_PARAMETERS:
            raise ValueError(f"{self.cfg['name']} at {self.cfg['parameters']:,} parameters runs "
                             f"on the card only")
        clock = Phases()
        w = lm.make(self.cfg, self.run.seed, self.device)
        clock.mark("weights")
        self.model = lm.build_model(self.cfg, w).eval()
        del w
        program.cast_for_serving(self.model, self.cfg)
        clock.mark("model")
        self.session = StreamingSession(self.model, batch_size=self.streams,
                                        dtype=program.DTYPES[self.mix["state_dtype"]],
                                        max_len=self.chunk * self.chunks)
        self.make_inputs()
        clock.mark("inputs")
        if self.run.trace:
            tracing.instrument(program.kernel_library())
        for k in range(2):  # both kinds of call: from an empty cache, and over a filled one
            self._call(0, k)
        clock.mark("warm-up")
        clock.log()
        self.position = 0  # the window starts a new set of documents

    def make_inputs(self) -> None:
        """The id pool, (pool_documents, document_chunks, streams,
        chunk_tokens) int64 in host memory (pinned with a card), each
        document drawn on the host from its own generator."""
        shape = (self.chunks, self.streams, self.chunk)
        on_card = self.device.type == "cuda"
        self.pool = torch.empty((self.mix["pool_documents"],) + shape, dtype=torch.int64,
                                pin_memory=on_card)
        for d in range(self.mix["pool_documents"]):
            rng = seeds.numpy_rng(self.run.seed, "ids", d)
            self.pool[d].copy_(torch.from_numpy(rng.integers(0, self.cfg["vocab_size"], shape)))

    def document(self, d: int) -> torch.Tensor:
        """Document ``d``'s ids, (document_chunks, streams, chunk_tokens)."""
        return self.pool[d % self.mix["pool_documents"]]

    # ------------------------------------------------------------- calls
    def _call(self, doc: int, k: int) -> dict:
        """Chunk ``k`` of every stream's document ``doc``."""
        self.calls += 1
        t_start = time.perf_counter()
        with tracing.label("copy_in"):
            ids = self.document(doc)[k].to(self.device, non_blocking=True)
        with tracing.label("process"):
            if k == 0 and self.session.offset != 0:
                self.session.reset()
            position = self.session.offset
            logits = self.session.process(ids)
        with tracing.label("logits_to_host"):
            logits = logits.cpu()
        t_end = time.perf_counter()
        return dict(start=t_start, end=t_end, batch=self.streams, chunk_tokens=self.chunk,
                    position=position, logits=logits)

    def _next(self) -> dict:
        doc, k = divmod(self.position, self.chunks)
        tapped = doc == self.checked[0] and k == self.chunks - 1
        hooks = self._tap_attention(self.checked[1]) if tapped else []
        try:
            rec = self._call(doc, k)
        finally:
            for h in hooks:
                h.remove()
        self.position += 1
        logits = rec.pop("logits")
        if doc == self.checked[0]:
            self.logits[k] = logits[self.checked[1]]
            if k == 0:
                self.first = logits
            if k == self.chunks - 1:
                self.snapshot = self._stream_state(self.checked[1])
        return rec

    def _tap_attention(self, row: int) -> list:
        """Forward hooks that keep row ``row`` of each attention mixer's
        output in :attr:`attention_out`; the caller removes them."""
        hooks = []
        for i, kind in enumerate(self.cfg["layer_types"]):
            if kind == "attention":
                def keep(module, args, out, i=i):
                    self.attention_out[i] = out[0][row].clone()
                hooks.append(self.model.layers[i].mixer.register_forward_hook(keep))
        return hooks

    def _stream_state(self, row: int) -> List[tuple]:
        """Row ``row`` of every layer's state: (conv, ssm), or the filled keys
        and values of a KV cache."""
        from videomamba_tpu_torch.streaming import KVCache

        out = []
        for entry in self.session.state:
            if isinstance(entry, KVCache):
                out.append((entry.key[row, :, :entry.length].clone(),
                            entry.value[row, :, :entry.length].clone()))
            else:
                out.append(tuple(t[row].clone() for t in entry))
        return out

    # ------------------------------------------------------------ window
    def measure(self, seconds: float) -> Window:
        records = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            records.append(self._next())
        window = Window("stream", t0, records, self.RANGE)
        self.attempted = len(records)
        while self.snapshot is None:  # the checked document's chunks, late but due
            self._next()
        return window

    def traced(self):
        """A whole document (``traced_chunks`` calls from a reset) under the
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
        """The reference's (logits after each chunk of the checked stream,
        every stream's logits after the first chunk, the checked stream's
        layer states at the document's end, its attention outputs over the
        last chunk), shaped as the program's. The checked stream's first
        logits come from its whole document's pass."""
        ref = self.run.reference
        doc, row = self.checked
        ids = self.document(doc).to(self.device)  # (chunks, streams, chunk)
        ends = [(k + 1) * self.chunk - 1 for k in range(self.chunks)]
        attention = {}
        with ref.no_tf32(), torch.no_grad():
            w = lm.make(self.cfg, self.run.seed, self.device)
            prod = ref.Products(precision)
            logits, states = ref.forward(w, self.cfg, ids[:, row].reshape(1, -1),
                                         logits_at=ends, prod=prod, attention_out=attention,
                                         attention_from=ends[-1] + 1 - self.chunk)
            first = torch.empty((self.streams, logits.shape[-1]))
            first[row] = logits[0, 0].cpu()
            others = [s for s in range(self.streams) if s != row]
            if others:
                first[others] = ref.forward(w, self.cfg, ids[0, others], prod=prod)[0][:, 0].cpu()
        return ({k: logits[0, k].cpu() for k in range(self.chunks)}, first,
                [tuple(t[0] for t in s) for s in states],
                {i: out[0] for i, out in attention.items()})

    def compare(self, got, want) -> dict:
        (logits, first, state, attention), (want_logits, want_first, want_state,
                                            want_attention) = got, want
        kinds = self.cfg["layer_types"]
        logit_err = max([compare.rel_err(logits.get(k, torch.empty(0)), want_logits[k])
                         for k in want_logits]
                        + [compare.rel_err(first[s], want_first[s])
                           for s in range(self.streams)])
        state_err = max(rel_err(g, wnt) for kind, layer, want_layer
                        in zip(kinds, state, want_state) if kind == "mamba"
                        for g, wnt in zip(layer, want_layer))
        kv_err = max(rel_err(g, wnt) for kind, layer, want_layer
                     in zip(kinds, state, want_state) if kind == "attention"
                     for g, wnt in zip(layer, want_layer))
        attn_err = max(rel_err(attention.get(i, torch.empty(0)), out)
                       for i, out in want_attention.items())
        return {"logit_err": logit_err, "state_err": state_err, "kv_err": kv_err,
                "attn_err": attn_err}

    def check(self) -> dict:
        return self.compare((self.logits, self.first, self.snapshot, self.attention_out),
                            self.reference_outputs())

    def control(self) -> dict:
        """The reference at fp8 products in the program's place (needs only
        :meth:`make_inputs`)."""
        return self.compare(self.reference_outputs("fp8"), self.reference_outputs())
