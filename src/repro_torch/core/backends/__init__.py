"""Port of ``src/repro/core/backends/__init__.py``
(copied; imports re-pointed, and a ``device`` for the receive path
added).

Backend registry: the five personalities the paper benchmarks + AUTO.

* MPI_GENERIC   — lowercase mpi4py send: generic serializer, copies, low
                  per-message overhead, IB on LAN, single connection;
                  concurrent sends pay multithreading overhead on LAN.
* MPI_MEM_BUFF  — uppercase Send: zero-copy buffers, near-C speed, IB verbs.
* GRPC          — protobuf serializer (slowest), TCP fallback on LAN, one
                  HTTP/2 connection per channel; concurrent dispatch = one
                  channel per receiver, each send buffers its own copy
                  (memory ∝ concurrency, Fig 2 bottom).
* TENSOR_RPC    — PyTorch RPC / TensorPipe: tensor-optimised zero-copy
                  serialisation, multi-connection transport.
* GRPC_S3       — the paper's hybrid (grpc_s3.py).
* AUTO          — §VII guideline: <10 MB or no object store -> GRPC;
                  trusted LAN -> MPI_MEM_BUFF; else GRPC_S3.
"""
from __future__ import annotations

from repro_torch.core.backends.base import BackendPolicy, CommBackend
from repro_torch.core.backends.grpc_s3 import GrpcS3Backend
from repro_torch.core.netsim import Environment
from repro_torch.core.transport import Fabric

MPI_GENERIC = BackendPolicy(
    name="mpi_generic", serializer="generic", conns_per_transfer=1,
    per_send_copy=True, staging_bytes=1 << 20, overhead_rtts=0.5,
    ser_parallel=False, lan_uses_ib=True, lan_concurrency_penalty=0.06)

MPI_MEM_BUFF = BackendPolicy(
    name="mpi_mem_buff", serializer="membuff", conns_per_transfer=1,
    per_send_copy=False, staging_bytes=4 << 20, overhead_rtts=0.5,
    ser_parallel=True, lan_uses_ib=True, lan_concurrency_penalty=0.06)

GRPC = BackendPolicy(
    name="grpc", serializer="protobuf", conns_per_transfer=1,
    per_send_copy=True, staging_bytes=2 << 20, overhead_rtts=1.0,
    ser_parallel=False, lan_uses_ib=False)

TENSOR_RPC = BackendPolicy(
    name="torch_rpc", serializer="tensor_rpc", conns_per_transfer=8,
    per_send_copy=False, staging_bytes=8 << 20, overhead_rtts=1.0,
    ser_parallel=True, lan_uses_ib=False)

POLICIES = {p.name: p for p in (MPI_GENERIC, MPI_MEM_BUFF, GRPC, TENSOR_RPC)}
BACKEND_NAMES = ["mpi_generic", "mpi_mem_buff", "grpc", "torch_rpc",
                 "grpc+s3", "auto"]


def make_backend(name: str, env: Environment, fabric: Fabric, host_id: str,
                 store=None, *, compression=None, wire_codec=None,
                 chunk_mb: float = 0.0, job=None, device=None, **kw):
    """``compression``/``wire_codec``/``chunk_mb`` configure the
    backend's wire stack (core/channel.py): 'qsgd[:block]' /
    'topk[:frac]' insert a payload CompressStage, 'zlib[:level]' a
    byte-domain WireCompressStage, chunk_mb > 0 a ChunkStage. Defaults
    reproduce the plain [SerializeStage] stack bit-for-bit. ``job`` (a
    ``transport.JobHandle``) binds the backend to one tenant of a
    multi-tenant fabric; None is the default single-job tenant.
    ``device`` is where the receive path reconstructs real payloads
    (core/channel.Channel.device; None: the card, resolved at the first
    real payload)."""
    from repro_torch.compression.stages import split_codecs
    # one shared rule: a byte codec named via `compression` moves to the
    # wire-domain slot; naming two different wire codecs is an error
    compression, wire_codec = split_codecs(compression, wire_codec)
    if name == "grpc+s3":
        return GrpcS3Backend(env, fabric, host_id, store,
                             compression=compression, wire_codec=wire_codec,
                             chunk_mb=chunk_mb, job=job, device=device, **kw)
    if name == "auto":
        from repro_torch.core.backends.auto import AutoBackend
        return AutoBackend(env, fabric, host_id, store,
                           compression=compression, wire_codec=wire_codec,
                           chunk_mb=chunk_mb, job=job, device=device, **kw)
    if name in POLICIES:
        return CommBackend(POLICIES[name], env, fabric, host_id, store,
                           compression=compression, wire_codec=wire_codec,
                           chunk_mb=chunk_mb, job=job, device=device)
    raise KeyError(f"unknown backend '{name}'; options: {BACKEND_NAMES}")


def available_backends(env: Environment, has_store: bool):
    """Which backends are deployable in an environment (paper Table/§VII)."""
    out = ["grpc"]
    if env.trusted:
        out += ["mpi_generic", "mpi_mem_buff", "torch_rpc"]
    else:
        # RPC/MPI need open peer paths / managed clusters; paper deploys
        # them cross-region via VPC peering for benchmarks
        out += ["mpi_generic", "mpi_mem_buff", "torch_rpc"]
    if has_store and env.name != "lan":
        out += ["grpc+s3"]
    return out
