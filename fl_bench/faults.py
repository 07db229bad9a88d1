"""Faults planted in the port's timed path, to show that the comparison
catches them: each is a context manager that patches the port for the
run inside it."""
from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged():
    """Every local step returns its parameters unchanged (the loss is
    still computed and reported)."""
    from repro_torch.launch import fl_train

    def make(orig):
        def make_train_fn(model):
            def train_fn(params, batch):
                loss, _ = model.loss(params, batch)
                return params, loss.detach()
            return train_fn
        return make_train_fn
    return _patched(fl_train, "make_train_fn", make)


def half_batch():
    """Every local step sees the first half of its batch, the mean taken
    over it alone."""
    from repro_torch.launch import fl_train

    def make(orig):
        def make_train_fn(model):
            step = orig(model)

            def train_fn(params, batch):
                return step(params, {k: v[: len(v) // 2]
                                     for k, v in batch.items()})
            return train_fn
        return make_train_fn
    return _patched(fl_train, "make_train_fn", make)


def altered():
    """Each client's update is altered where it is produced: its largest
    leaf scaled by 1.01."""
    from repro_torch import _tree
    from repro_torch.core.message import TensorPayload
    from repro_torch.fl.client import FLClient

    def make(orig):
        def run_round(client, msg, *args, **kw):
            update, timing, t = orig(client, msg, *args, **kw)
            if isinstance(update.payload, TensorPayload):
                leaves, treedef = _tree.flatten(update.payload.tree)
                i = max(range(len(leaves)), key=lambda j: leaves[j].numel())
                leaves[i] = leaves[i] * 1.01
                update.payload = TensorPayload(_tree.unflatten(treedef,
                                                               leaves))
            return update, timing, t
        return run_round
    return _patched(FLClient, "run_round", make)


def norms_frozen():
    """Every local step leaves the one-dimensional leaves (the norms'
    scales and shifts, the classifier's bias) as it got them."""
    from repro_torch import _tree
    from repro_torch.launch import fl_train

    def make(orig):
        def make_train_fn(model):
            step = orig(model)

            def train_fn(params, batch):
                new, loss = step(params, batch)
                old, _ = _tree.flatten(params)
                out, treedef = _tree.flatten(new)
                kept = [o.clone() if o.dim() == 1 else n
                        for o, n in zip(old, out)]
                return _tree.unflatten(treedef, kept), loss
            return train_fn
        return make_train_fn
    return _patched(fl_train, "make_train_fn", make)


@contextlib.contextmanager
def stale():
    """Every client is served the first global model it received again, as
    a content cache whose key misses a change serves it."""
    from repro_torch.core.backends.base import CommBackend
    from repro_torch.core.backends.grpc_s3 import GrpcS3Backend
    from repro_torch.core.message import TensorPayload
    first = {}

    def make(orig):
        def recv(backend, now):
            out = []
            for msg, ready in orig(backend, now):
                tree = getattr(msg.payload, "tree", None)
                if msg.msg_type == "model_sync" and tree is not None:
                    msg = dataclasses.replace(msg, payload=TensorPayload(
                        first.setdefault(msg.receiver, tree)))
                out.append((msg, ready))
            return out
        return recv
    with _patched(CommBackend, "recv", make), \
            _patched(GrpcS3Backend, "recv", make):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "norms_frozen": norms_frozen, "stale": stale}
