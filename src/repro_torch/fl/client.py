"""Port of ``src/repro/fl/client.py``.

FL client: local training + timing breakdown.

Two compute modes:
* live       — real local SGD on the client's silo shard (tests,
               examples, small tiers);
* simulated  — training time charged from the tier's calibrated
               per-round seconds (paper-scale Fig 5 runs with virtual
               payloads).

Migration = host<->accelerator staging of the payload (the paper's
'CPU-GPU migration' state); charged at PCIe-class bandwidth.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import resolve_device, synchronize
from repro_torch.core.message import FLMessage, TensorPayload, VirtualPayload

PCIE_BW = 12e9  # bytes/s host<->device staging


def _on(leaf, device):
    """A received host array (or tensor) as a tensor on ``device``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.tensor(leaf, device=device)  # copies; wires are read-only


@dataclasses.dataclass
class ClientTiming:
    communication: float = 0.0
    migration: float = 0.0
    serialization: float = 0.0
    waiting: float = 0.0
    training: float = 0.0


class FLClient:
    def __init__(self, client_id: str, backend, *, dataset=None,
                 train_fn: Optional[Callable] = None,
                 sim_train_s: float = 0.0, batch_size: int = 16,
                 straggle_factor: float = 1.0, seed: int = 0,
                 device=None):
        """train_fn(params, batch) -> (new_params, loss tensor).

        ``sim_train_s`` > 0 with a live ``train_fn`` trains for real but
        charges the calibrated time instead of measured wall seconds —
        "live compute, simulated clock". ``device`` is where the client
        trains: the received host tree and each batch are moved there.
        ``None`` means the card, resolved at the first live step, so a
        simulated-mode client builds on a machine without one."""
        self.client_id = client_id
        self.backend = backend
        self.dataset = dataset
        self.train_fn = train_fn
        self.sim_train_s = sim_train_s
        self.batch_size = batch_size
        self.straggle_factor = straggle_factor
        self.seed = seed
        self.device = None if device is None else torch.device(device)
        self._round = 0
        self._sends = 0  # distinct virtual updates must not alias in the
        # object store's content-addressed cache (each round re-uploads)

    # ------------------------------------------------------------------
    def local_train(self, params, local_steps: int):
        """Live local training. Returns (new_params, mean_loss, seconds)."""
        t0 = time.perf_counter()
        if self.device is None:
            self.device = resolve_device()
        dev = self.device
        params = _tree.map(lambda a: _on(a, dev), params)
        it = self.dataset.batches(self.batch_size, seed=self.seed + self._round)
        losses = []
        for _ in range(local_steps):
            batch = {k: _on(v, dev) for k, v in next(it).items()}
            params, loss = self.train_fn(params, batch)
            losses.append(float(loss))
        # the work is queued on the device: wait for it before the clock
        # is read, as the measured seconds enter the simulated round
        synchronize(_tree.leaves(params)[0])
        return params, float(np.mean(losses)), time.perf_counter() - t0

    # ------------------------------------------------------------------
    def run_round(self, msg: FLMessage, ready_t: float, local_steps: int,
                  server_id: str = "server"):
        """Handle one received global model; returns (update_msg, timing,
        send_start_t). Works in live or simulated mode depending on the
        payload type."""
        self._round = msg.round
        timing = ClientTiming()
        payload = msg.payload
        nbytes = payload.nbytes
        # host -> device staging
        mig_in = nbytes / PCIE_BW
        timing.migration += mig_in
        t = ready_t + mig_in

        if isinstance(payload, VirtualPayload) or self.train_fn is None:
            train_s = self.sim_train_s * self.straggle_factor
            self._sends += 1
            update_payload = VirtualPayload(
                nbytes, tag=f"upd:{self.client_id}:{self._sends}")
            num_examples = 128
        else:
            new_params, loss, train_s = self.local_train(payload.tree,
                                                         local_steps)
            if self.sim_train_s > 0:
                train_s = self.sim_train_s  # live compute, simulated clock
            train_s *= self.straggle_factor
            update_payload = TensorPayload(new_params)
            num_examples = self.dataset.num_examples()
            self.last_loss = loss
        timing.training += train_s
        t += train_s
        # device -> host staging of the update
        mig_out = update_payload.nbytes / PCIE_BW
        timing.migration += mig_out
        t += mig_out
        update = FLMessage("client_update", self.client_id, server_id,
                           round=msg.round, payload=update_payload,
                           metadata={"num_examples": num_examples,
                                     # global version this update was
                                     # trained against (async staleness)
                                     "version": msg.metadata.get(
                                         "version", msg.round)})
        return update, timing, t
