"""Port of ``src/repro/configs/base.py``: ``ModelConfig`` (the LM
families' architecture description), ``ShapeConfig`` (one input shape),
``MeshConfig`` (a physical mesh and how logical axes map onto it) with
the reference's four meshes, ``TrainConfig`` (the optimizer and step),
``FLConfig`` and its one conversion to a ``Scenario``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the LM families (dense/moe/ssm/hybrid/audio/vlm)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_interleave: int = 1  # MoE every k-th layer (1 = every layer)
    d_ff_dense: int = 0  # FFN width of non-MoE layers when interleaved
    num_shared_experts: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0  # zamba2: shared attention block every k mamba blocks
    shared_attn_lora_rank: int = 0
    slstm_every: int = 0  # xlstm: sLSTM block every k blocks (others mLSTM)
    mlstm_chunk: int = 256

    # VLM
    cross_attn_every: int = 0  # cross-attention layer every k layers
    num_image_tokens: int = 0
    vision_d_model: int = 0

    # audio (encoder-only): inputs are precomputed frame embeddings
    external_embeddings: bool = False

    # embeddings / io
    tie_embeddings: bool = False
    mlp_gelu: bool = False  # 2-matrix GELU MLP (ViT/BERT) instead of SwiGLU

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # memory policy
    remat: str = "full"  # none | dots | full
    attn_chunk: int = 1024  # flash-style KV chunking for prefill/train
    block_causal: bool = True  # lower-triangular block schedule (skip masked blocks)

    # MoE dispatch
    moe_group_size: int = 2048
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads must be divisible by num_kv_heads")

    # ------------------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def moe_layer_mask(self) -> Sequence[bool]:
        """True for layers that carry a MoE FFN."""
        if self.num_experts == 0:
            return [False] * self.num_layers
        k = self.moe_interleave
        # MoE on layers (k-1, 2k-1, ...) — matches Llama-4 style interleaving.
        return [(i % k) == (k - 1) for i in range(self.num_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (used for payload tiers + MODEL_FLOPS)."""
        from repro_torch.models import registry  # lazy to avoid cycles

        return registry.param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Physical mesh + logical-axis resolution plan."""

    shape: tuple
    axis_names: tuple
    # mesh axes that implement FSDP-style parameter/optimizer sharding
    fsdp_axes: tuple = ("data",)
    # mesh axes that implement tensor parallelism
    tensor_axes: tuple = ("model",)
    # mesh axes over which the batch is split
    batch_axes: tuple = ("pod", "data")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]


SINGLE_POD_MESH = MeshConfig(shape=(16, 16), axis_names=("data", "model"))
MULTI_POD_MESH = MeshConfig(
    shape=(2, 16, 16),
    axis_names=("pod", "data", "model"),
    fsdp_axes=("data",),
)
# FSDP over pod+data: used for the very largest models (llama4-maverick).
MULTI_POD_MESH_FSDP_POD = dataclasses.replace(MULTI_POD_MESH, fsdp_axes=("pod", "data"))
SMOKE_MESH = MeshConfig(shape=(1, 1), axis_names=("data", "model"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / step configuration."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    optimizer: str = "adamw"  # adamw | sgd
    moment_dtype: str = "float32"  # float32 | bfloat16 (memory-reduced states)
    microbatches: int = 1  # gradient accumulation steps per global step
    # cross-pod (cross-silo) sync policy — the paper's FL round at pod scale
    crosspod_sync_every: int = 1  # 1 = fully synchronous DP over 'pod'
    crosspod_compression: str = "none"  # none | int8 | topk


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Cross-silo federated learning round configuration."""

    num_clients: int = 7
    clients_per_round: int = 7
    local_epochs: int = 1
    local_steps: int = 10
    rounds: int = 5
    backend: str = "grpc+s3"
    # topology preset (scenario.TOPOLOGY_PRESETS): the legacy trio plus
    # the graph-native star | ring | multi_hub
    environment: str = "geo_distributed"
    quorum_fraction: float = 1.0  # server aggregates once this fraction reported
    round_deadline_s: float = 0.0  # 0 = no deadline (wait for quorum only)
    server_lr: float = 1.0
    seed: int = 0

    # event-driven runtime (fl/scheduler.py; mode != "sync" selects a
    # strategy from fl/async_strategies.py)
    mode: str = "sync"  # sync | fedbuff | semisync | hier | vertical
    buffer_k: int = 0  # fedbuff merge buffer; 0 -> max(2, num_clients // 2)
    staleness_exponent: float = 0.5  # alpha in the (1+s)^-alpha discount
    max_staleness: int = 0  # discard updates staler than this; 0 = keep all
    # FedAsync-style adaptivity: scale alpha by each update's percentile
    # rank among observed staleness (fl/async_strategies.py)
    staleness_adaptive: bool = False
    # fleet-scale knobs (fl/scheduler.py): seeded K-of-N cohort sampling
    # for fedbuff/semisync (0 = whole fleet), and streaming hub
    # aggregation (fold updates into one O(model) accumulator instead of
    # buffering O(clients) payloads at the server)
    cohort_k: int = 0
    streaming_hub: bool = False

    # vertical / split FL (fl/vertical.py; mode == "vertical"): layer
    # boundary of the bottom/top cut, per-batch exchanges per round, and
    # the codec on the activation/gradient wires
    cut_layer: int = 1
    batches_per_round: int = 8
    activation_codec: str = "none"

    # wire pipeline (core/channel.py): gradient compression on the client
    # update path — and, in hier mode, on the relay WAN hop only (the LAN
    # reduce stays exact) — plus chunked send pipelining
    compression: str = "none"  # none | qsgd[:block] | topk[:frac]
    # byte-domain wire codec on every backend channel (lossless, so it
    # rides all modes and both directions): none | zlib[:level]
    wire_codec: str = "none"
    chunk_mb: float = 0.0  # 0 = unchunked wires

    # fault & churn injection (fl/fault.py, core/netsim.LinkFaultModel)
    # availability trace spec: "" = no churn; "auto:UP/DOWN" = generated
    # exponential up/down periods; else explicit "client0:leave@T,join@T"
    availability_trace: str = ""
    link_loss_rate: float = 0.0  # per-chunk wire loss on every direct link
    region_quorum: float = 0.5  # hier: min live fraction per region
    relay_conns: int = 8  # hier: WAN-hop connection multiplexing per relay
    relay_depth: int = 1  # hier: relay-tree levels (1 = single-tier)

    # -- the one FLConfig <-> Scenario conversion ------------------------
    def to_scenario(self, *, tier: str = "small", local_steps: int = 4,
                    store_fail_rate: float = 0.0):
        """Lift this flat config into the declarative ``Scenario`` spec.

        This and its inverse, ``Scenario.fl_config()``, are THE two
        conversion points between the flat runtime config and the
        declarative spec — every entry point (``fl_train``, tests,
        examples) routes through them, so a field added to one side must
        be added to both or the round-trip tests fail. Implemented by
        ``Scenario.from_fl_config`` (the Scenario side owns the field
        mapping); ``tier`` / ``local_steps`` / ``store_fail_rate`` are
        deployment knobs with no FLConfig field."""
        from repro_torch.scenario import Scenario
        return Scenario.from_fl_config(self, tier=tier,
                                       local_steps=local_steps,
                                       store_fail_rate=store_fail_rate)
