"""The local SGD step replayed from a CUDA graph.

Eagerly, one step of ResNet56 or MobileNetV3 is some 2,500-3,100 launches
from the host, and the card waits on them. The step's work is the same in
every call of one input signature (no host synchronisation, no random
numbers, batch-statistic norms), so ``launch/fl_train.make_train_fn``
captures it once per signature into a ``torch.cuda.CUDAGraph`` and
replays it:

* the caller's leaves are copied into one flat static input buffer (one
  ``copy_`` when they are the views the previous call returned, else one
  ``torch._foreach_copy_``), the batch into static batch buffers;
* the graph runs the eager step on views of that buffer and writes the new
  leaves into one flat static output buffer;
* one ``clone()`` of it gives fresh memory, returned as contiguous views in
  the tree's shapes (a caller may hold the tree while the next replay
  runs), the loss a clone too.

``Flat`` places each leaf at an offset of ``ALIGN_BYTES``, the caching
allocator's block alignment, so every view starts where a tensor of its
own would: the same vectorised paths and cuDNN engines as eager tensors.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch import obs

ALIGN_BYTES = 512
WARMUP = 3  # eager iterations on a side stream before capture (backward
# needs its lazy set-up done outside the capture)


def signature(treedef, leaves, batch) -> tuple:
    """The key of one captured graph: the tree's structure, the leaves' and
    the batch's shapes, dtypes and devices, and the flags that choose the
    kernels (TF32 in matmuls and in cuDNN, cuDNN's deterministic mode)."""
    return (treedef,
            tuple((tuple(l.shape), l.dtype, l.device) for l in leaves),
            tuple((k, tuple(v.shape), v.dtype, v.device)
                  for k, v in sorted(batch.items())),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)


class Flat:
    """The layout of a list of leaves of one dtype in one flat buffer:
    leaf ``i`` at ``offsets[i]``, a multiple of ``ALIGN_BYTES``."""

    def __init__(self, leaves):
        dtypes = {l.dtype for l in leaves}
        if len(dtypes) != 1:
            raise ValueError(f"Flat: the leaves must share one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        self.dtype = dtypes.pop()
        align = max(1, ALIGN_BYTES // self.dtype.itemsize)
        self.offsets, self._views, off = [], [], 0
        for l in leaves:
            shape = tuple(l.shape)
            self.offsets.append(off)
            self._views.append((shape, torch.empty(shape, device="meta")
                                .stride(), off))
            off += -(-l.numel() // align) * align
        self.numel = off

    def empty(self, device) -> torch.Tensor:
        """A zeroed buffer (the gaps between leaves stay zero)."""
        return torch.zeros(self.numel, dtype=self.dtype, device=device)

    def views(self, buf) -> list:
        """The leaves as contiguous views of ``buf``, in their shapes (one
        ``as_strided`` each: a third of the host time of a slice and a
        ``view``)."""
        return [buf.as_strided(*v) for v in self._views]

    def views_of(self, leaves, buf) -> bool:
        """Whether ``leaves`` are this layout's views of ``buf``, in order."""
        return all(l._base is buf and l.storage_offset() == o
                   and l.is_contiguous()
                   for l, o in zip(leaves, self.offsets))


class GraphedStep:
    """One input signature's step, captured and replayed. ``step(leaves,
    batch) -> (new leaves, loss)`` is the eager step; it must not
    synchronise with the host or draw random numbers."""

    def __init__(self, step, leaves, batch):
        self.step = step
        self.flat = Flat(leaves)
        device = leaves[0].device
        self.inp = self.flat.empty(device)
        self.out = self.flat.empty(device)
        self.inp_views = self.flat.views(self.inp)
        self.out_views = self.flat.views(self.out)
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=v.device)
                      for k, v in batch.items()}
        self.graph = None
        self.loss = None
        self._last = None  # weakref to the flat buffer last returned

    def _load(self, leaves, batch) -> None:
        last = self._last() if self._last is not None else None
        if last is not None and self.flat.views_of(leaves, last):
            self.inp.copy_(last)
        else:
            torch._foreach_copy_(self.inp_views, list(leaves))
        for k, v in batch.items():
            self.batch[k].copy_(v)

    def _body(self) -> torch.Tensor:
        new, loss = self.step(self.inp_views, self.batch)
        torch._foreach_copy_(self.out_views, new)
        return loss

    def _result(self, loss):
        out = self.out.clone()
        self._last = weakref.ref(out)
        return self.flat.views(out), loss.clone()

    def capture(self, leaves, batch):
        """Warm up on static copies of the inputs, capture, and return the
        last warm-up iteration's result: one step on ``leaves``."""
        obs.count("client.step.captures")
        with obs.span("client.step.capture"):
            self._load(leaves, batch)
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream(device=self.inp.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    loss = self._body()
            main.wait_stream(side)
            result = self._result(loss)
            del loss  # freed here, not inside the capture
            torch.cuda.synchronize(self.inp.device)
            graph = torch.cuda.CUDAGraph()
            # the stream context restores the caller's stream even when
            # the capture fails
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    loss = self._body()
                finally:
                    graph.capture_end()
            self.graph, self.loss = graph, loss
        return result

    def __call__(self, leaves, batch):
        """One step on ``leaves`` and ``batch``, replayed."""
        obs.count("client.step.graphed")
        self._load(leaves, batch)
        self.graph.replay()
        return self._result(self.loss)
