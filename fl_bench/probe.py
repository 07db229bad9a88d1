"""Spans, counters and the run's schedule, taken by the benchmark's own
wrappers around the port's calls into each layer. A wrapper calls the
port's function with the same arguments and returns its result; the
untraced run adds no synchronisation, the traced one synchronises the
card around each span so its host time is the layer's whole cost.

What is always recorded (both runs):
- each client update's latency: from the client's ``recv`` that hands it
  the global model to the server holding the decoded update (the end of
  the server's ``recv`` of it; in a sync round the update passes to the
  server in process, so at the end of ``FLClient.run_round``);
- the schedule: which client trained on which global version, and which
  updates each aggregation took;
- each update's mean local loss, as ``FLClient.local_train`` returns it,
  and in set-up the loss of its first local step;
- the per-leaf norms of each global model a client trains on, and of the
  server's global model of each version, left on the card until the run
  ends (no synchronisation).

What the traced run adds: ``train_step`` (the local SGD step), ``input``
(the batch drawn and moved to the card), ``aggregate`` (FedAvg and the
server merge), ``wire`` (serialize and the byte codec, both ways),
``codec`` (the payload codec, compress and decompress), and profiler
ranges around the device ops whose roofline share is reported.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from fl_bench import counts

# device op -> (roofline group, logical bytes of one call)
RANGES = {"fedavg_aggregate": ("fedavg", counts.fedavg_bytes),
          "topk_flat_batch": ("codec", counts.topk_bytes),
          "quantize_rows_batch": ("codec", counts.quantize_bytes),
          "dequantize_rows": ("codec", counts.dequantize_bytes)}


class Probe:
    def __init__(self, *, mode: str, trace: bool, cuda: bool):
        self.mode = mode
        self.trace = trace
        self.cuda = cuda
        self.in_window = False
        self.profiling = False
        self.spans = defaultdict(float)
        self.counts = defaultdict(int)
        self.update_start = {}
        self.update_ms = []
        self.update_began = []  # each counted update's start, as update_ms
        self.losses = {}
        self.first_losses = {}
        self.window_opened = False
        self.schedule = []
        self.versions = {}  # version -> the server's per-leaf norms
        self.served = []  # (version, per-leaf norms a client trained on)
        self.tree_owner = {}
        self.range_bytes = defaultdict(int)
        self.after_aggregation = None
        self._patches = []
        self._codec_depth = 0

    # -- plumbing ------------------------------------------------------
    def patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._patches.append((owner, name, orig))

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._patches):
            setattr(owner, name, orig)
        self._patches.clear()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def timed(self, name: str, fn, *args, **kw):
        """``fn(*args)``, its host seconds added to span ``name`` when the
        traced run is inside the window, the card synchronised around."""
        if not (self.trace and self.in_window):
            return fn(*args, **kw)
        self.sync()
        t0 = time.perf_counter()
        with self.annotate(name):
            out = fn(*args, **kw)
            self.sync()
        self.spans[name] += time.perf_counter() - t0
        return out

    def annotate(self, name: str):
        if not self.profiling:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"fl_bench.{name}")

    @staticmethod
    def norms(tree):
        """Per-leaf norms of a parameter tree, as one tensor on its
        device."""
        from repro_torch import _tree
        return torch.stack(torch._foreach_norm(
            [torch.as_tensor(l).float() for l in _tree.leaves(tree)]))

    # -- updates -------------------------------------------------------
    def update_done(self, client_id: str, round_: int, t: float) -> None:
        start = self.update_start.pop((client_id, round_), None)
        if start is not None and self.in_window:
            self.update_ms.append((t - start) * 1e3)
            self.update_began.append(start)

    def install(self, clients, silos) -> None:
        from repro_torch.core.backends.base import CommBackend
        from repro_torch.core.backends.grpc_s3 import GrpcS3Backend
        from repro_torch.fl import client as client_mod
        from repro_torch.fl import scheduler as sched_mod
        from repro_torch.fl import server as server_mod
        probe = self

        def recv(orig):
            def wrapped(backend, now):
                t0 = time.perf_counter()
                out = orig(backend, now)
                t1 = time.perf_counter()
                for msg, _ in out:
                    if msg.msg_type == "model_sync":
                        probe.update_start[(msg.receiver, msg.round)] = t0
                    elif msg.msg_type == "client_update" \
                            and probe.mode != "sync":
                        probe.update_done(msg.sender, msg.round, t1)
                return out
            return wrapped
        self.patch(CommBackend, "recv", recv)
        self.patch(GrpcS3Backend, "recv", recv)

        def run_round(orig):
            def wrapped(client, msg, ready_t, local_steps, *a, **kw):
                tree = getattr(msg.payload, "tree", None)
                if tree is not None:
                    probe.served.append((msg.round, probe.norms(tree)))
                out = orig(client, msg, ready_t, local_steps, *a, **kw)
                update = out[0]
                tree = getattr(update.payload, "tree", None)
                if tree is not None:
                    probe.tree_owner[id(tree)] = (client.client_id, msg.round)
                if probe.mode == "sync":
                    probe.update_done(client.client_id, msg.round,
                                      time.perf_counter())
                return out
            return wrapped
        self.patch(client_mod.FLClient, "run_round", run_round)

        def local_train(orig):
            def wrapped(client, params, local_steps):
                out = orig(client, params, local_steps)
                probe.losses[(client.client_id, client._round)] = out[1]
                return out
            return wrapped
        self.patch(client_mod.FLClient, "local_train", local_train)

        def sync_fedavg(orig):
            def wrapped(updates, weights):
                probe.schedule.append([
                    {"client": probe.tree_owner[id(u)][0],
                     "version": probe.tree_owner[id(u)][1]}
                    for u in updates])
                return probe.timed("aggregate", orig, updates, weights)
            return wrapped
        self.patch(server_mod, "fedavg", sync_fedavg)

        def aggregate(orig):
            def wrapped(sched, records, now):
                records = list(records)
                if sched.finished or not records:
                    return orig(sched, records, now)
                probe.schedule.append([
                    {"client": r.client.client_id, "version": r.version}
                    for r in records])
                done = orig(sched, records, now)
                if probe.after_aggregation is not None:
                    probe.after_aggregation(sched)
                return done
            return wrapped
        self.patch(sched_mod.FLScheduler, "aggregate", aggregate)

        for c in clients:
            c.train_fn = self._step(c, c.train_fn)
        if self.trace:
            self._install_traced(silos)

    def _step(self, client, train_fn):
        """The client's local step, counted in the window; in set-up the
        loss of each update's first step is kept for the check."""
        probe = self

        def step(params, batch):
            if probe.in_window:
                probe.counts["train_steps"] += 1
            out = probe.timed("train_step", train_fn, params, batch)
            key = (client.client_id, client._round)
            if not probe.window_opened and key not in probe.first_losses:
                probe.first_losses[key] = float(out[1])
            return out
        return step

    def _install_traced(self, silos) -> None:
        from repro_torch.compression import stages
        from repro_torch.core import channel as channel_mod
        from repro_torch.core import serialization
        from repro_torch.fl import client as client_mod
        from repro_torch.fl import scheduler as sched_mod
        from repro_torch.kernels import ops
        probe = self

        def plain(name):
            def make(orig):
                def wrapped(*args, **kw):
                    if not probe.in_window:
                        return orig(*args, **kw)
                    t0 = time.perf_counter()
                    with probe.annotate(name):
                        out = orig(*args, **kw)
                    probe.spans[name] += time.perf_counter() - t0
                    return out
                return wrapped
            return make

        def synced(name, count=None):
            def make(orig):
                def wrapped(*args, **kw):
                    if count is not None and probe.in_window:
                        probe.counts[count] += 1
                    return probe.timed(name, orig, *args, **kw)
                return wrapped
            return make

        # input: the batch drawn on the host and moved to the card
        self.patch(client_mod, "_on", plain("input"))
        for silo in silos:
            silo.batches = self._timed_batches(silo.batches)
        # aggregation on the event-driven path (sync: ``sync_fedavg``)
        self.patch(sched_mod, "fedavg", synced("aggregate"))
        self.patch(sched_mod, "merge_global", synced("aggregate"))
        # the wire: serialize and the byte codec, both ways
        self.patch(serialization.BaseSerializer, "serialize", synced("wire"))
        self.patch(channel_mod, "decode_wire",
                   synced("wire", count="wire_messages"))
        self.patch(channel_mod.WireCompressStage, "compress", synced("wire"))
        self.patch(stages.ZlibCodec, "decompress_wire", synced("wire"))
        # the payload codec, outermost call only (decode_batch nests)
        for owner, name in ((stages.BaseCodec, "compress"),
                            (stages.BaseCodec, "decompress"),
                            (stages.FlatBatchCodec, "encode_batch"),
                            (stages.BaseCodec, "decode_batch"),
                            (stages.QsgdCodec, "decode_batch")):
            self.patch(owner, name, self._codec_span(name))
        # device ops whose roofline share is read from the trace
        for name in RANGES:
            self.patch(ops, name, self._range(name))

    def _timed_batches(self, batches):
        probe = self

        def wrapped(batch_size, seed=0):
            it = batches(batch_size, seed=seed)
            while True:
                if not probe.in_window:
                    yield next(it)
                    continue
                t0 = time.perf_counter()
                with probe.annotate("input"):
                    b = next(it)
                probe.spans["input"] += time.perf_counter() - t0
                yield b
        return wrapped

    def _codec_span(self, name: str):
        probe = self

        def make(orig):
            def wrapped(codec, payloads, *args, **kw):
                if probe._codec_depth or not probe.in_window:
                    return orig(codec, payloads, *args, **kw)
                if name == "compress":
                    probe.counts["codec_updates"] += 1
                elif name == "encode_batch":
                    probe.counts["codec_updates"] += len(payloads)
                probe._codec_depth += 1
                try:
                    return probe.timed("codec", orig, codec, payloads,
                                       *args, **kw)
                finally:
                    probe._codec_depth -= 1
            return wrapped
        return make

    def _range(self, name: str):
        group, nbytes = RANGES[name]
        probe = self

        def make(orig):
            def wrapped(*args, **kw):
                if not probe.profiling:
                    return orig(*args, **kw)
                probe.sync()
                with torch.profiler.record_function(
                        f"fl_bench.range.{group}"):
                    out = orig(*args, **kw)
                    probe.sync()
                probe.range_bytes[group] += nbytes(args, out)
                return out
            return wrapped
        return make
