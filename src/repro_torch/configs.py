"""Model configs for the PyTorch port.

A copy of ``ModelConfig`` (with the ``MoEConfig`` / ``SSMConfig`` field
types it names), of ``OptimConfig``, of the registry entries the port
serves and trains, and of the dry run's shape grid (``ShapeConfig``,
``SHAPES``, ``shape_applicable``): the port
imports nothing of ``repro``, not even its framework-free modules, so it
keeps its own copy. Field names, defaults and values match the JAX package
field by field (``tests/test_torch_models.py`` checks it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block parameters."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence block parameters (RWKV6, Mamba2)."""

    kind: str  # "rwkv6" | "mamba2"
    heads: int
    head_dim: int
    state_dim: int  # per-head recurrent state width
    chunk: int = 128  # chunked-scan block length (sequence dim)
    conv_dim: int = 4  # mamba2 short conv width
    expand: int = 2  # mamba2 inner expansion


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. Families:

    dense  — decoder-only transformer (GQA)
    moe    — decoder-only transformer with MoE FFN
    ssm    — attention-free (RWKV6)
    hybrid — Mamba2 backbone + shared attention block (Zamba2)
    encdec — encoder-decoder transformer (Whisper), audio frontend stubbed
    vlm    — decoder-only backbone + vision patch frontend stubbed (LLaVA)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec (whisper): n_layers is the decoder depth; enc_layers the encoder.
    enc_layers: int = 0
    # hybrid (zamba2): apply the single shared attention block every N layers.
    shared_attn_every: int = 0
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    # number of stub frontend embeddings prepended to the token sequence
    n_frontend_tokens: int = 0
    dtype: str = "bfloat16"
    # True if sequence mixing is sub-quadratic (eligible for long_500k).
    sub_quadratic: bool = False
    # per-(shape-name) microbatch size per data shard for gradient accumulation
    microbatch: Mapping[str, int] = field(default_factory=dict)
    # serving: tokens per KV page for the SkyByte paged-KV runtime.
    kv_page_size: int = 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, h, kv, hd, ff, L = (
            self.d_model,
            self.n_heads,
            self.n_kv_heads,
            self.resolved_head_dim,
            self.d_ff,
            self.n_layers,
        )
        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += self.vocab * d  # lm head
        if self.family in ("dense", "moe", "vlm", "encdec"):
            attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if self.family == "moe" and self.moe is not None:
                ffn = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                if self.moe.shared_expert:
                    ffn += 3 * d * (self.moe.d_ff_shared or ff)
            else:
                ffn = 3 * d * ff
            n += L * (attn + ffn + 2 * d)
            if self.family == "encdec":
                # encoder blocks + decoder cross-attention
                n += self.enc_layers * (attn + 3 * d * ff + 2 * d)
                n += L * (attn + d)  # cross attn + its norm
        elif self.family == "ssm":
            s = self.ssm
            inner = s.heads * s.head_dim
            # rwkv6: time-mix (r,k,v,g,o + decay/first) + channel-mix
            n += L * (5 * d * inner + 2 * inner + 3 * d * ff // 2 + 2 * d)
        elif self.family == "hybrid":
            s = self.ssm
            inner = self.d_model * s.expand
            mamba = d * 2 * inner + inner * s.conv_dim + inner * (
                2 * s.state_dim
            ) + inner * d + 2 * s.heads
            n += L * (mamba + 2 * d)
            attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            n += attn + 3 * d * ff + 2 * d  # one shared block
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — differs for MoE."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        m = self.moe
        total = self.param_count()
        all_experts = L * m.num_experts * 3 * d * m.d_ff_expert
        active = L * m.top_k * 3 * d * m.d_ff_expert
        return total - all_experts + active


# ---------------------------------------------------------------------------
# registry (every arch of the JAX package)
# ---------------------------------------------------------------------------


def qwen3_1p7b() -> ModelConfig:
    """qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
    vocab=151936 — qk_norm, GQA, untied embeddings."""
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 4},
    )


def qwen3_1p7b_reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab=128,
        qk_norm=True,
        microbatch={"train_4k": 2},
    )


def smollm_135m() -> ModelConfig:
    """smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
    vocab=49152 — llama-arch small, tied embeddings."""
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49_152,
        tie_embeddings=True,
        rope_theta=10_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 8},
    )


def smollm_135m_reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-reduced",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=128,
        vocab=128,
        tie_embeddings=True,
        microbatch={"train_4k": 2},
    )


def qwen25_32b() -> ModelConfig:
    """qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
    vocab=152064 — GQA with QKV bias."""
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27_648,
        vocab=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 2},
    )


def qwen25_32b_reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=128,
        qkv_bias=True,
        microbatch={"train_4k": 2},
    )


def mistral_large_123b() -> ModelConfig:
    """mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
    d_ff=28672 vocab=32768."""
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12_288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        vocab=32_768,
        rope_theta=1_000_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 1},
    )


def mistral_large_123b_reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-reduced",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=224,
        vocab=128,
        microbatch={"train_4k": 2},
    )


def olmoe_1b_7b() -> ModelConfig:
    """olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 (expert)
    vocab=50304, MoE 64 experts top-8, qk-norm."""
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50_304,
        qk_norm=True,
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
        rope_theta=10_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 4},
    )


def olmoe_1b_7b_reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=128,
        qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96),
        microbatch={"train_4k": 2},
    )


def llama4_scout() -> ModelConfig:
    """llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8)
    d_ff=8192 vocab=202048, MoE 16 experts top-1 + a shared expert (the
    text backbone)."""
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202_048,
        moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True, d_ff_shared=8192),
        rope_theta=500_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 1},
    )


def llama4_scout_reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=128,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=96, shared_expert=True, d_ff_shared=96),
        microbatch={"train_4k": 2},
    )


def llava_next_34b() -> ModelConfig:
    """llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
    vocab=64000; the vision frontend is a stub (precomputed patch
    embeddings are an input, projected and prepended to the tokens)."""
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20_480,
        vocab=64_000,
        frontend="vision",
        n_frontend_tokens=1152,  # anyres: base 576 + 576 tile patches (2x2 pooled)
        rope_theta=5_000_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 1},
    )


def llava_next_34b_reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-reduced",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=128,
        frontend="vision",
        n_frontend_tokens=16,
        microbatch={"train_4k": 2},
    )


def whisper_base() -> ModelConfig:
    """whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
    Encoder-decoder; the conv audio frontend is a stub: frame embeddings of
    length seq_len // 4 are an input."""
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,  # decoder depth
        enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51_865,
        frontend="audio",
        rope_theta=10_000.0,
        sub_quadratic=False,
        microbatch={"train_4k": 16},
    )


def whisper_base_reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-reduced",
        family="encdec",
        n_layers=2,
        enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        frontend="audio",
        microbatch={"train_4k": 2},
    )


def rwkv6_3b() -> ModelConfig:
    """rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960
    vocab=65536 — Finch: data-dependent decay linear recurrence."""
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # head_dim 64
        n_kv_heads=40,
        d_ff=8960,
        vocab=65_536,
        ssm=SSMConfig(kind="rwkv6", heads=40, head_dim=64, state_dim=64, chunk=64),
        sub_quadratic=True,
        microbatch={"train_4k": 4},
    )


def rwkv6_3b_reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-reduced",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        ssm=SSMConfig(kind="rwkv6", heads=4, head_dim=16, state_dim=16, chunk=32),
        sub_quadratic=True,
        microbatch={"train_4k": 2},
    )


def zamba2_7b() -> ModelConfig:
    """zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32, head_dim 112)
    d_ff=14336 vocab=32000, ssm_state=64 — Mamba2 backbone + one shared
    attention block applied every 6 layers (fully shared weights)."""
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14_336,
        vocab=32_000,
        ssm=SSMConfig(kind="mamba2", heads=56, head_dim=128, state_dim=64, chunk=128),
        shared_attn_every=6,
        rope_theta=10_000.0,
        sub_quadratic=True,
        microbatch={"train_4k": 2},
    )


def zamba2_7b_reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=128,
        ssm=SSMConfig(kind="mamba2", heads=4, head_dim=32, state_dim=16, chunk=32),
        shared_attn_every=2,
        sub_quadratic=True,
        microbatch={"train_4k": 2},
    )


@dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """The published Zamba2 block (family "zamba2", ``models/zamba2.py``):
    what ``ModelConfig`` does not say. A subclass, so that ``ModelConfig``
    keeps the JAX package's fields one for one; each field defaults to what
    the "hybrid" family computes.

    ``head_dim`` is the shared attention's (its input is ``concat(x, x0)``,
    2 x d wide); ``ssm.heads`` x ``ssm.head_dim`` is the Mamba inner width."""

    ssm_groups: int = 1  # B and C groups: head h reads group h // (heads / groups)
    conv_bias: bool = False
    hybrid_layer_ids: Tuple[int, ...] = ()  # Mamba layers a shared block runs before
    num_mem_blocks: int = 1  # shared blocks, taken in turn by the sites
    adapter_rank: int = 0  # each site's LoRA on the FFN's gate/up projection
    ffn_act: str = "silu"  # "silu" (SwiGLU) or "gelu" (the erf GELU)


def zamba2_7b_instruct() -> Zamba2Config:
    """Zamba2-7B-Instruct at its published widths and depth
    (huggingface.co/Zyphra/Zamba2-7B-Instruct, config.json): 81 Mamba2
    layers (112 heads of 64 in 2 groups, state 64, conv 4 with bias), two
    shared blocks taken in turn by the 13 hybrid sites (32 heads of 224 over
    concat(x, x0), GELU FFN of 14336 with a rank-128 adapter a site), tied
    embedding, vocab 32000. Not in the registry: the JAX package has no
    such model."""
    return Zamba2Config(
        name="zamba2-7b-instruct",
        family="zamba2",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=224,
        d_ff=14_336,
        vocab=32_000,
        tie_embeddings=True,
        rope_theta=10_000.0,
        norm_eps=1e-5,
        ssm=SSMConfig(kind="mamba2", heads=112, head_dim=64, state_dim=64, chunk=256, conv_dim=4, expand=2),
        sub_quadratic=True,
        ssm_groups=2,
        conv_bias=True,
        hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
        num_mem_blocks=2,
        adapter_rank=128,
        ffn_act="gelu",
    )


def zamba2_tiny() -> Zamba2Config:
    """The CPU tests' twin of ``zamba2_7b_instruct``: every mechanism (groups,
    conv bias, two shared blocks over concat(x, x0), adapters) at a width and
    depth a test runs in seconds."""
    return Zamba2Config(
        name="zamba2-tiny",
        family="zamba2",
        n_layers=7,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=48,
        vocab=128,
        tie_embeddings=True,
        ssm=SSMConfig(kind="mamba2", heads=8, head_dim=8, state_dim=8, chunk=16, conv_dim=4, expand=2),
        sub_quadratic=True,
        ssm_groups=2,
        conv_bias=True,
        hybrid_layer_ids=(1, 3, 4, 6),
        num_mem_blocks=2,
        adapter_rank=4,
        ffn_act="gelu",
    )


_REGISTRY: Dict[str, Tuple] = {
    "qwen2.5-32b": (qwen25_32b, qwen25_32b_reduced),
    "mistral-large-123b": (mistral_large_123b, mistral_large_123b_reduced),
    "smollm-135m": (smollm_135m, smollm_135m_reduced),
    "qwen3-1.7b": (qwen3_1p7b, qwen3_1p7b_reduced),
    "olmoe-1b-7b": (olmoe_1b_7b, olmoe_1b_7b_reduced),
    "llama4-scout-17b-a16e": (llama4_scout, llama4_scout_reduced),
    "llava-next-34b": (llava_next_34b, llava_next_34b_reduced),
    "whisper-base": (whisper_base, whisper_base_reduced),
    "rwkv6-3b": (rwkv6_3b, rwkv6_3b_reduced),
    "zamba2-7b": (zamba2_7b, zamba2_7b_reduced),
}

ARCH_IDS: Tuple[str, ...] = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch][0]()


def get_reduced(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch][1]()


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell. kind selects which step is lowered:
    train -> train_step, prefill -> prefill, decode -> serve_step."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per DESIGN.md §Shape skips."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return True, ""


@dataclass(frozen=True)
class OptimConfig:
    """AdamW, its cosine schedule and the int8 gradient compression (copy of
    ``repro/configs/base.py::OptimConfig``)."""

    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # distributed-optimization tricks
    compress_grads: bool = False  # int8 + error-feedback DP all-reduce
