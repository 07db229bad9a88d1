"""Port of ``src/repro/fl/vertical.py``: ``SplitPlan`` and its three
adapters, the sizing helpers, ``VerticalLive`` and ``VerticalStrategy``.

The strategy's event logic is the reference's, copied. The live parts
run on torch autograd in place of ``jax.vjp`` / ``jax.value_and_grad``:
the feature party's forward keeps its graph (the activations and the
leaves they were computed from) until the activation gradient comes
back, and every SGD update is out of place (``p - lr * g`` into new
tensors), as the reference's ``jax.tree.map`` is. Batches pipeline, so a
later batch's forward may read parameters that an earlier batch's
backward then replaces: its graph must keep the ones it read. And the
CLI hands every party the same bottom tree object, so an update in place
would make the parties share one bottom.

Cut-boundary activations leave the bottom in the reference's layout
(NHWC for the convnets, (B, S, D) for the transformer), so the codecs'
rows and the wire bytes match the reference.

Vertical / split federated learning — the latency-bound workload.

Horizontal FL ships one model-sized update per client per round; the
paper's §VII decision table (gRPC below the ~10 MB knee, gRPC+S3 above)
is derived from that wire profile. Vertical / split FL inverts it: the
model is cut at a layer boundary into a *bottom* (feature party, holds
the inputs) and a *top* (label party, holds the labels), and every
training batch crosses the wire twice — forward activations up,
activation gradients back. Per-message payloads are small (a batch of
hidden states, not a parameter tree) but there are ``2 * batches_per_
round`` of them per client per round, so per-message latency dominates
and store round-trips (two S3 REST latencies per hop) are poison. This
module provides:

* ``SplitPlan``        — cuts a model of the zoo (ResNet / MobileNetV3 /
  dense TransformerLM) at a configurable unit boundary; split forward +
  backward compose to the unsplit model's numerics (tested).
* ``VerticalStrategy`` — an ``AggregationStrategy`` driving the per-batch
  activation/gradient exchange as first-class EventLoop events, with
  batch-level pipelining: the feature party computes batch *i+1* while
  batch *i*'s activations are still in flight. All traffic flows through
  the backends' ``Channel.encode/decode`` stacks, so qsgd/topk error
  feedback (per direction), zlib wire codecs, chunking + LinkFaultModel
  retransmit, churn, and AUTO per-message routing apply unmodified.

Who ships what: the feature party (client) ships activations and is
charged the client->server wire time; the label party (server) ships
activation gradients and is charged the server->client wire time; the
round-close bookkeeping reuses ``FLScheduler.aggregate`` with small
virtual records (a vertical round updates parties in place — there is
no model-sized merge).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import _tree
from repro_torch.core.message import FLMessage, TensorPayload, VirtualPayload
from repro_torch.fl.async_strategies import AggregationStrategy
from repro_torch.fl.scheduler import FLScheduler, UpdateRecord
from repro_torch.models import layers as L
from repro_torch.models.transformer import unstacked
from repro_torch.models.vision import conv, hard_swish, norm_apply


# ---------------------------------------------------------------------------
# SplitPlan: cut a zoo model into bottom (feature party) / top (label party)
# ---------------------------------------------------------------------------

class _ResNetAdapter:
    """Cut between residual blocks (stem is always bottom, head always
    top); unit i is the i-th block in (stage, block) order."""

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        self.coords = [(si, bi) for si in range(len(cfg.widths))
                       for bi in range(cfg.blocks_per_stage)]

    @property
    def n_units(self) -> int:
        return len(self.coords)

    def split_params(self, p, cut: int):
        blocks = [p[f"stage{si}"][bi] for (si, bi) in self.coords]
        bottom = {"stem": p["stem"], "blocks": list(blocks[:cut])}
        top = {"blocks": list(blocks[cut:]), "head": p["head"]}
        return bottom, top

    def merge_params(self, bottom, top):
        cfg = self.model.cfg
        blocks = list(bottom["blocks"]) + list(top["blocks"])
        p = {"stem": bottom["stem"]}
        bps = cfg.blocks_per_stage
        for si in range(len(cfg.widths)):
            p[f"stage{si}"] = blocks[si * bps:(si + 1) * bps]
        p["head"] = top["head"]
        return p

    def _block(self, blk, x, si, bi):
        stride = 2 if (si > 0 and bi == 0) else 1
        h = torch.relu(norm_apply(blk["bn1"], conv(x, blk["c1"], stride)))
        h = norm_apply(blk["bn2"], conv(h, blk["c2"]))
        sc = conv(x, blk["proj"], stride) if "proj" in blk else x
        return torch.relu(h + sc)

    def bottom_forward(self, bottom, batch, cut: int):
        x = norm_apply(bottom["stem"]["bn"],
                       conv(batch["images"], bottom["stem"]["w"]))
        x = torch.relu(x)
        for i, blk in enumerate(bottom["blocks"]):
            x = self._block(blk, x, *self.coords[i])
        return x

    def top_loss(self, top, acts, batch, cut: int):
        x = acts
        for j, blk in enumerate(top["blocks"]):
            x = self._block(blk, x, *self.coords[cut + j])
        x = torch.mean(x, dim=(1, 2))
        logits = x @ top["head"]["w"] + top["head"]["b"]
        return L.cross_entropy(logits[:, None, :], batch["labels"][:, None],
                               z_loss=0.0), {}


class _MobileNetAdapter:
    """Cut between inverted-residual blocks (stem bottom, head top)."""

    def __init__(self, model):
        self.model = model

    @property
    def n_units(self) -> int:
        return len(self.model.cfg.blocks)

    def split_params(self, p, cut: int):
        bottom = {"stem": p["stem"], "blocks": list(p["blocks"][:cut])}
        top = {"blocks": list(p["blocks"][cut:]), "head": p["head"]}
        return bottom, top

    def merge_params(self, bottom, top):
        return {"stem": bottom["stem"],
                "blocks": list(bottom["blocks"]) + list(top["blocks"]),
                "head": top["head"]}

    def _block(self, blk, x, spec):
        (_, _, stride, _) = spec
        h = hard_swish(norm_apply(blk["bn_e"], conv(x, blk["expand"])))
        c_mid = h.shape[-1]
        h = hard_swish(norm_apply(
            blk["bn_d"], conv(h, blk["dw"], stride, groups=c_mid)))
        if "se_down" in blk:
            s = torch.mean(h, dim=(1, 2), keepdim=True)
            s = torch.relu(conv(s, blk["se_down"]))
            s = torch.sigmoid(conv(s, blk["se_up"]))
            h = h * s
        h = norm_apply(blk["bn_p"], conv(h, blk["project"]))
        if stride == 1 and h.shape[-1] == x.shape[-1]:
            h = h + x
        return h

    def bottom_forward(self, bottom, batch, cut: int):
        cfg = self.model.cfg
        x = hard_swish(norm_apply(
            bottom["stem"]["bn"], conv(batch["images"], bottom["stem"]["w"],
                                       2)))
        for spec, blk in zip(cfg.blocks[:cut], bottom["blocks"]):
            x = self._block(blk, x, spec)
        return x

    def top_loss(self, top, acts, batch, cut: int):
        cfg = self.model.cfg
        x = acts
        for spec, blk in zip(cfg.blocks[cut:], top["blocks"]):
            x = self._block(blk, x, spec)
        head = top["head"]
        x = hard_swish(norm_apply(head["bn"], conv(x, head["w"])))
        x = torch.mean(x, dim=(1, 2))
        x = hard_swish(x @ head["fc1"])
        logits = x @ head["fc2"] + head["b"]
        return L.cross_entropy(logits[:, None, :], batch["labels"][:, None],
                               z_loss=0.0), {}


class _TransformerAdapter:
    """Cut between transformer layers of a plain dense stack: the token
    embedding table rides with the bottom (the feature party holds the
    raw tokens), the LM head + final norm with the top."""

    def __init__(self, model):
        cfg = model.cfg
        segments = model.segments
        if segments != [(("self",), cfg.num_layers)]:
            raise ValueError(
                f"SplitPlan: only plain dense stacks are splittable; "
                f"{cfg.name} plans segments {segments}")
        if cfg.tie_embeddings:
            raise ValueError(
                "SplitPlan: tie_embeddings couples the bottom's embedding "
                "table to the top's LM head — untie to split")
        if cfg.external_embeddings:
            raise ValueError("SplitPlan: external-embedding (encoder-only) "
                             "models have no token side to cut at")
        self.model = model

    @property
    def n_units(self) -> int:
        return self.model.cfg.num_layers

    def split_params(self, p, cut: int):
        seg = p["seg0"]["b0_self"]  # layers stacked on the leading axis
        bottom = {"embedding": p["embed"]["embedding"],
                  "layers": _tree.map(lambda a: a[:cut], seg)}
        top = {"lm_head": p["embed"]["lm_head"],
               "final_norm": p["embed"]["final_norm"],
               "layers": _tree.map(lambda a: a[cut:], seg)}
        return bottom, top

    def merge_params(self, bottom, top):
        seg = _tree.map(lambda a, b: torch.cat([a, b], dim=0),
                        bottom["layers"], top["layers"])
        embed = {"embedding": bottom["embedding"],
                 "lm_head": top["lm_head"],
                 "final_norm": top["final_norm"]}
        return {"embed": embed, "seg0": {"b0_self": seg}}

    def _run_layers(self, layers, x, positions):
        for layer in unstacked(layers):
            x, _ = self.model._block_apply("self", layer, x,
                                           positions=positions)
        return x

    def bottom_forward(self, bottom, batch, cut: int):
        cfg = self.model.cfg
        x = L.embed_lookup({"embedding": bottom["embedding"]},
                           batch["tokens"], cfg, L.dtype_of(cfg.dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        return self._run_layers(bottom["layers"], x, positions)

    def top_loss(self, top, acts, batch, cut: int):
        cfg = self.model.cfg
        positions = torch.arange(acts.shape[1], dtype=torch.int32,
                                 device=acts.device)
        x = self._run_layers(top["layers"], acts, positions)
        logits = L.lm_logits({"lm_head": top["lm_head"],
                              "final_norm": top["final_norm"]}, x, cfg)
        ce = L.cross_entropy(logits, batch["targets"])
        return ce, {}  # dense self blocks carry zero aux loss


def _adapter_for(model):
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.models.vision import MobileNetV3, ResNet
    if isinstance(model, ResNet):
        return _ResNetAdapter(model)
    if isinstance(model, MobileNetV3):
        return _MobileNetAdapter(model)
    if isinstance(model, TransformerLM):
        return _TransformerAdapter(model)
    raise TypeError(f"SplitPlan: no split adapter for "
                    f"{type(model).__name__} (splittable: ResNet, "
                    f"MobileNetV3, dense TransformerLM)")


class SplitPlan:
    """A vertical cut of one zoo model at unit boundary ``cut_layer``.

    The feature party owns units ``[0, cut_layer)`` plus the input-side
    extras (conv stem / token embedding); the label party owns units
    ``[cut_layer, n_units)`` plus the output head. ``bottom_forward`` +
    ``top_loss`` compose to the unsplit model's ``loss`` and
    ``split_params`` / ``merge_params`` round-trip the parameter tree —
    both properties are what tests/test_torch_vertical.py locks."""

    def __init__(self, model, cut_layer: int):
        self.model = model
        self.adapter = _adapter_for(model)
        self.cut_layer = int(cut_layer)
        n = self.adapter.n_units
        if not 1 <= self.cut_layer <= n - 1:
            raise ValueError(
                f"SplitPlan: cut_layer {cut_layer} out of range for "
                f"{type(model).__name__} — valid cuts are 1..{n - 1} "
                f"({n} splittable units)")

    @property
    def n_units(self) -> int:
        return self.adapter.n_units

    def split_params(self, params):
        """-> (bottom, top): disjoint parameter trees for the parties."""
        return self.adapter.split_params(params, self.cut_layer)

    def merge_params(self, bottom, top):
        """Inverse of ``split_params`` (exact tree round-trip)."""
        return self.adapter.merge_params(bottom, top)

    def bottom_forward(self, bottom, batch):
        """Feature-party forward: inputs -> cut-boundary activations."""
        return self.adapter.bottom_forward(bottom, batch, self.cut_layer)

    def top_loss(self, top, acts, batch):
        """Label-party loss from cut-boundary activations -> (loss, aux)."""
        return self.adapter.top_loss(top, acts, batch, self.cut_layer)

    def loss(self, bottom, top, batch):
        """Composed split loss — equals the unsplit ``model.loss``."""
        return self.top_loss(top, self.bottom_forward(bottom, batch), batch)


# ---------------------------------------------------------------------------
# sizing helpers (sim mode)
# ---------------------------------------------------------------------------

# Proxy unit depth per payload tier, for apportioning a tier's calibrated
# per-round train seconds between the bottom and top parties. Matches the
# zoo: resnet56 has 27 blocks, mobilenetv3 14, distilbert 6 layers, and
# vit-large 24.
TIER_DEPTH = {"small": 27, "medium": 14, "big": 6, "large": 24}

#: per-batch examples assumed when sizing simulated activation tensors
SIM_BATCH_SIZE = 32


def bottom_fraction(cut_layer: int, depth: int) -> float:
    """Fraction of one batch's compute the feature party performs."""
    return min(0.95, max(0.05, cut_layer / max(depth, 1)))


def sim_activation_nbytes(payload_bytes: float, batch_size: int,
                          cut_layer: int) -> int:
    """Activation-tensor bytes for one batch at the cut, from the tier's
    model payload size. A model of P parameter bytes has ~sqrt(P/4)
    hidden width; one batch of fp32 hidden states is ``batch * 4 *
    width`` bytes, halved per unit of cut depth (pooling/striding shrinks
    the feature map as the cut moves up). ~1 MB for the big tier at
    batch 32 and cut 1 — squarely below AUTO's 10 MB knee, which is the
    whole fig13 story."""
    width = math.sqrt(max(payload_bytes, 4.0) / 4.0)
    nbytes = batch_size * 4.0 * width / (2.0 ** (cut_layer - 1))
    return max(1024, int(nbytes))


# ---------------------------------------------------------------------------
# the live bundle (real tensors through the wire stack)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VerticalLive:
    """Real-compute mode: the strategy carries actual split parameters
    and runs SGD on both parties; activation/gradient payloads are real
    ``TensorPayload`` trees (so lossy codecs + error feedback act on
    them). ``batch_fn(client_id, round, batch) -> batch dict`` must be
    deterministic — both parties call it for their halves."""
    plan: SplitPlan
    bottoms: Dict[str, Any]  # client_id -> feature-party params
    top: Any  # label-party params (server side)
    batch_fn: Callable[[str, int, int], dict]
    lr: float = 0.05


def _sgd(params, grads, lr):
    """``p - lr * g`` over a tree's leaves, into new tensors."""
    leaves, treedef = _tree.flatten(params)
    with torch.no_grad():
        return _tree.unflatten(treedef, [p - lr * g
                                         for p, g in zip(leaves, grads)])


def _grad_leaves(tree):
    """-> (leaves detached from ``tree`` and requiring grad, treedef)."""
    leaves, treedef = _tree.flatten(tree)
    return [l.detach().requires_grad_(True) for l in leaves], treedef


# ---------------------------------------------------------------------------
# VerticalStrategy
# ---------------------------------------------------------------------------

class VerticalStrategy(AggregationStrategy):
    """Per-batch split-training rounds on the event loop.

    One round = ``batches_per_round`` forward/backward exchanges per
    feature party, all parties concurrent. Per client the pipeline is:

      server --round_start(meta)--> client
      client: compute bottom batch b   (computes run back-to-back:
              batch i+1 overlaps batch i's wire time)
      client --activation b--> server   (client's channel: codec + EF)
      server: top forward/backward on its per-party executor line
      server --grad b--> client         (server's channel: codec + EF)
      client: bottom backward           -> batch b complete

    The round closes when every registered batch completed or was
    abandoned (transfer failure after bounded retries, or churn); the
    close books one small virtual ``UpdateRecord`` per participating
    party through ``FLScheduler.aggregate`` — weight = completed
    batches — which bumps the version and starts the next round.
    """

    name = "vertical"

    #: give up on one message after this many send attempts (mirrors the
    #: scheduler's bounded upload retries)
    MAX_ATTEMPTS = 3
    #: consecutive rounds with zero completed batches before the
    #: strategy goes idle (a fully dead fabric must not spin the loop)
    MAX_EMPTY_ROUNDS = 25

    def __init__(self, *, cut_layer: int = 1, batches_per_round: int = 8,
                 activation_nbytes: int = 1 << 20, train_s: float = 20.0,
                 bottom_frac: float = 0.5, live: Optional[VerticalLive] = None):
        if cut_layer < 1:
            raise ValueError("cut_layer must be >= 1")
        if batches_per_round < 1:
            raise ValueError("batches_per_round must be >= 1")
        self.cut_layer = int(cut_layer)
        self.batches_per_round = int(batches_per_round)
        self.activation_nbytes = int(activation_nbytes)
        self.train_s = float(train_s)
        self.bottom_frac = float(bottom_frac)
        self.live = live
        b = self.batches_per_round
        self.bottom_s = self.train_s * self.bottom_frac / b
        self.top_s = self.train_s * (1.0 - self.bottom_frac) / b
        self.round_id = 0
        self.pending: Dict[str, int] = {}  # cid -> batches not yet resolved
        self.completed: Dict[str, int] = {}  # cid -> batches completed
        self._top_busy: Dict[str, float] = {}  # per-party top executor line
        # (cid, round, batch) -> (activations, the bottom leaves they were
        # computed from, the bottom's treedef): the bottom's graph
        self._vjp: Dict[tuple, Any] = {}
        self._idle = False
        self._empty_rounds = 0
        self._closing = False

    # -- bootstrap ---------------------------------------------------------
    def start(self, sched: FLScheduler, now: float):
        self.sched = sched
        self._begin_round(sched, now)

    # -- round lifecycle ---------------------------------------------------
    def _begin_round(self, sched: FLScheduler, now: float):
        if sched.finished:
            return
        live = [c for c in sched.clients if sched.is_up(c.client_id)]
        if not live:
            # nothing to drive; churn joins re-enter via on_join
            self._idle = True
            return
        self._idle = False
        self._closing = False
        self.round_id = sched.version
        self.pending = {c.client_id: self.batches_per_round for c in live}
        self.completed = {c.client_id: 0 for c in live}
        for c in live:
            self._send_round_start(sched, c, now, 0)

    def _ctrl_msg(self, sched: FLScheduler, client) -> FLMessage:
        return FLMessage("round_start", sched.backend.host_id,
                         client.client_id, round=self.round_id,
                         metadata={"version": self.round_id})

    def _send_round_start(self, sched: FLScheduler, client, now: float,
                          attempt: int):
        cid = client.client_id
        if sched.finished or not sched.is_up(cid):
            self._abandon_party(sched, cid, now)
            return
        h = sched.backend.isend(self._ctrl_msg(sched, client), now)
        if sched._track(h, f"vstart>{cid}", self._on_client_msgs,
                        client=client):
            return
        if attempt + 1 < self.MAX_ATTEMPTS:
            sched.loop.call_at(
                max(now, h.start) + sched.redispatch_backoff_s,
                f"vstart-retry>{cid}",
                lambda t, c=client, a=attempt: self._send_round_start(
                    sched, c, t, a + 1))
        else:
            self._abandon_party(sched, cid, now)

    def _abandon_party(self, sched: FLScheduler, cid: str, now: float):
        """This party sits the round out (unreachable or departed)."""
        if self.pending.pop(cid, None) is not None:
            self._maybe_close(sched, now)

    # -- client side -------------------------------------------------------
    def _on_client_msgs(self, now: float, client):
        """Drain one feature party's inbox: round_start bootstraps the
        batch pipeline, grads complete batches."""
        sched = self.sched
        for msg, ready in client.backend.recv(now):
            if msg.msg_type == "round_start":
                if msg.round != self.round_id or sched.finished:
                    continue  # stale bootstrap from a closed round
                if not sched.is_up(client.client_id):
                    continue
                # pipelined computes: batch b finishes its bottom pass at
                # ready + (b+1)*bottom_s and its isend is non-blocking, so
                # batch i+1 computes while batch i's activations fly
                sched.loop.call_at_many(
                    [(ready + (b + 1) * self.bottom_s,
                      f"vact>{client.client_id}", self._send_activation,
                      dict(client=client, round_=msg.round, batch=b,
                           attempt=0))
                     for b in range(self.batches_per_round)])
            elif msg.msg_type == "grad":
                sched.loop.call_at(ready, f"vbwd<{client.client_id}",
                                   self._on_grad, client=client, msg=msg)

    def _send_activation(self, now: float, client, round_: int, batch: int,
                         attempt: int):
        sched = self.sched
        cid = client.client_id
        if sched.finished or round_ != self.round_id:
            return
        if not sched.is_up(cid) or cid not in self.pending:
            return
        if self.live is not None:
            data = self.live.batch_fn(cid, round_, batch)
            leaves, treedef = _grad_leaves(self.live.bottoms[cid])
            acts = self.live.plan.bottom_forward(
                _tree.unflatten(treedef, leaves), data)
            self._vjp[(cid, round_, batch)] = (acts, leaves, treedef)
            payload = TensorPayload({"acts": acts.detach()})
        else:
            payload = VirtualPayload(self.activation_nbytes,
                                     tag=f"act:{cid}:r{round_}:b{batch}")
        msg = FLMessage("activation", cid, sched.backend.host_id,
                        round=round_, payload=payload,
                        metadata={"batch": batch})
        h = client.backend.isend(msg, now)
        if sched._track(h, f"vact-arrive<{cid}", self._on_server_msgs):
            return
        if attempt + 1 < self.MAX_ATTEMPTS:
            sched.loop.call_at(
                max(now, h.start) + sched.redispatch_backoff_s,
                f"vact-retry>{cid}", self._send_activation, client=client,
                round_=round_, batch=batch, attempt=attempt + 1)
        else:
            sched.discarded += 1
            self._vjp.pop((cid, round_, batch), None)
            self._batch_done(sched, cid, round_, now, ok=False)

    # -- server side -------------------------------------------------------
    def _on_server_msgs(self, now: float):
        sched = self.sched
        for msg, ready in sched.backend.recv(now):
            if msg.msg_type != "activation":
                continue
            sched.loop.call_at(ready, f"vtop<{msg.sender}",
                               self._on_activation, msg=msg)

    def _on_activation(self, now: float, msg: FLMessage):
        sched = self.sched
        cid = msg.sender
        if sched.finished or msg.round != self.round_id:
            sched.discarded += 1  # landed after its round closed
            return
        if cid not in self.pending:
            return  # party abandoned / churned out mid-round
        client = sched._by_id.get(cid)
        batch = int(msg.metadata.get("batch", 0))
        # per-party top executor: one serialized compute line per feature
        # party (parties are independent label-side jobs), so activations
        # queue behind the previous batch of the *same* party only
        start = max(now, self._top_busy.get(cid, 0.0))
        done = start + self.top_s
        self._top_busy[cid] = done
        if self.live is not None:
            data = self.live.batch_fn(cid, msg.round, batch)
            top, treedef = _grad_leaves(self.live.top)
            acts = msg.payload.tree["acts"].to(top[0].device)
            acts = acts.detach().requires_grad_(True)
            loss, _ = self.live.plan.top_loss(_tree.unflatten(treedef, top),
                                              acts, data)
            *g_top, g_acts = torch.autograd.grad(loss, top + [acts])
            self.live.top = _sgd(self.live.top, g_top, self.live.lr)
            if client is not None:
                client.last_loss = float(loss.detach())
            payload = TensorPayload({"g": g_acts})
        else:
            payload = VirtualPayload(
                self.activation_nbytes,
                tag=f"grad:{cid}:r{msg.round}:b{batch}")
        sched.loop.call_at(done, f"vgrad>{cid}", self._send_grad,
                           client=client, round_=msg.round, batch=batch,
                           payload=payload, attempt=0)

    def _send_grad(self, now: float, client, round_: int, batch: int,
                   payload, attempt: int):
        sched = self.sched
        cid = client.client_id
        if sched.finished or round_ != self.round_id:
            return
        if not sched.is_up(cid) or cid not in self.pending:
            return
        msg = FLMessage("grad", sched.backend.host_id, cid, round=round_,
                        payload=payload, metadata={"batch": batch})
        h = sched.backend.isend(msg, now)
        if sched._track(h, f"vgrad-arrive>{cid}", self._on_client_msgs,
                        client=client):
            return
        if attempt + 1 < self.MAX_ATTEMPTS:
            sched.loop.call_at(
                max(now, h.start) + sched.redispatch_backoff_s,
                f"vgrad-retry>{cid}", self._send_grad, client=client,
                round_=round_, batch=batch, payload=payload,
                attempt=attempt + 1)
        else:
            sched.discarded += 1
            self._vjp.pop((cid, round_, batch), None)
            self._batch_done(sched, cid, round_, now, ok=False)

    def _on_grad(self, now: float, client, msg: FLMessage):
        sched = self.sched
        cid = client.client_id
        if sched.finished or msg.round != self.round_id:
            sched.discarded += 1
            return
        if cid not in self.pending:
            return
        batch = int(msg.metadata.get("batch", 0))
        if self.live is not None:
            graph = self._vjp.pop((cid, msg.round, batch), None)
            if graph is not None:
                acts, leaves, _ = graph
                g = msg.payload.tree["g"].to(acts.device)
                g_bottom = torch.autograd.grad(acts, leaves, grad_outputs=g)
                # the party's current bottom, which an earlier batch's
                # backward may have replaced since this batch's forward
                self.live.bottoms[cid] = _sgd(self.live.bottoms[cid],
                                              g_bottom, self.live.lr)
        self._batch_done(sched, cid, msg.round, now, ok=True)

    # -- round close -------------------------------------------------------
    def _batch_done(self, sched: FLScheduler, cid: str, round_: int,
                    now: float, *, ok: bool):
        if round_ != self.round_id or cid not in self.pending:
            return
        self.pending[cid] -= 1
        if ok:
            self.completed[cid] = self.completed.get(cid, 0) + 1
        if self.pending[cid] <= 0:
            del self.pending[cid]
        self._maybe_close(sched, now)

    def _maybe_close(self, sched: FLScheduler, now: float):
        if self._closing or self.pending or sched.finished:
            return
        self._closing = True
        records = []
        for cid, n_done in self.completed.items():
            if n_done <= 0:
                continue
            records.append(UpdateRecord(
                client=sched._by_id.get(cid),
                payload=VirtualPayload(self.activation_nbytes,
                                       tag=f"vupd:{cid}:r{self.round_id}"),
                weight=float(n_done), version=self.round_id, staleness=0,
                arrive_t=now, count=1))
        if records:
            self._empty_rounds = 0
            done = sched.aggregate(records, now)
        else:
            self._empty_rounds += 1
            if self._empty_rounds >= self.MAX_EMPTY_ROUNDS:
                self._idle = True  # dead fabric: stop driving the loop
                return
            done = now + sched.redispatch_backoff_s
        if not sched.loop.stopped:
            self._begin_round(sched, done)

    # -- churn -------------------------------------------------------------
    def on_update(self, sched: FLScheduler, rec: UpdateRecord, now: float):
        pass  # vertical traffic never reaches the client_update path

    def on_leave(self, sched: FLScheduler, client, now: float):
        """A feature party departed mid-round: its in-flight batches die
        (round/membership guards drop late arrivals) and the round closes
        without it. Batches it already completed still count."""
        self._abandon_party(sched, client.client_id, now)

    def on_join(self, sched: FLScheduler, client, now: float):
        """(Re)joined parties fold in at the next round boundary — there
        is no model to re-fetch; the party's bottom stays local. If the
        fleet had emptied out entirely, the join restarts the cadence."""
        if self._idle and not sched.finished:
            self._empty_rounds = 0
            self._begin_round(sched, now)
