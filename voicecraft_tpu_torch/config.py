"""Model and training configuration and presets (PyTorch port of
voicecraft_tpu/config.py: ``ModelConfig``, ``TrainConfig`` and ``PRESETS``).

Field names are those of the reference's flags, so a reference checkpoint's
pickled args and a config.json written by either package load 1:1
(``from_dict``).  ``audio_vocab_size`` is an int and ``codebook_weight`` a
tuple of floats, where the reference eval()'s strings.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture and token layout (reference config.py:54-84)."""

    # token layout (reference config.py:67-73)
    n_codebooks: int = 4
    text_vocab_size: int = 100
    text_pad_token: int = 100
    audio_vocab_size: int = 2048
    empty_token: int = 2048
    eog: int = 2049
    audio_pad_token: int = 2050
    eos: int = -1            # >0 for TTS-enhanced models (=2051)
    n_special: int = 3       # empty, eog, pad (+eos -> 4)
    special_first: int = 0
    reduced_eog: int = 0

    # mask-span sampling (training), reference config.py:55-66
    max_n_spans: int = 3
    mask_len_min: int = 1
    mask_len_max: int = 600
    min_gap: int = 5
    max_mask_portion: float = 0.7
    mask_sample_dist: str = "poisson1"
    shuffle_mask_embedding: int = 0

    # model dims (reference config.py:76-84)
    d_model: int = 2048
    audio_embedding_dim: int = 2048
    nhead: int = 16
    num_decoder_layers: int = 16
    text_embedding_dropout: float = 0.1
    audio_embedding_dropout: float = 0.0
    text_positional_embedding_dropout: float = 0.1
    audio_positional_embedding_dropout: float = 0.1
    trm_dropout: float = 0.1

    # data / sequence caps (reference config.py:46-52)
    encodec_sr: int = 50
    audio_max_length: float = 20.0
    text_max_length: int = 400

    # loss
    codebook_weight: Optional[Tuple[float, ...]] = None

    # multi-token prediction heads: n_mtp groups predict the tokens at
    # offsets +2 .. +(n_mtp + 1) (speculative decoding's drafts), trained by
    # an auxiliary loss of weight mtp_weight (on detached hiddens when
    # mtp_detach)
    n_mtp: int = 0
    mtp_weight: float = 0.5
    mtp_detach: int = 1

    # compute policy: activations in compute_dtype, trained weights kept in
    # param_dtype (f32 master weights, cast at each product)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # training attention: "dense" (the segment bias, with attention-prob
    # dropout) or "chunked" (query chunks, nothing of S x S kept for the
    # backward, no attention-prob dropout)
    train_attn: str = "dense"
    norm: str = "layernorm"
    ffn_activation: str = "relu"
    # the layer stack's recompute policy in training: "full" | "dots" |
    # "attn" | "attn_ffn1" | "none" (models/transformer.py:apply_stack)
    train_remat: str = "full"

    # the decoder block: "voicecraft" (models/transformer.py) or
    # "deepseek_v2" (models/deepseek_v2.py: latent attention over a latent
    # slab, RMSNorm, a dense SwiGLU in the first first_k_dense_replace
    # layers and routed + shared SwiGLU experts after them).  The fields
    # below are DeepSeek-V2's config.json keys; VoiceCraft's block reads
    # none of them.
    block: str = "voicecraft"
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    intermediate_size: int = 0
    moe_intermediate_size: int = 0
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    moe_layer_freq: int = 1
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # YaRN (rope_scaling of type "yarn"), flat; a factor of 1 is plain RoPE
    yarn_factor: float = 1.0
    yarn_original_max_position_embeddings: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # ---- derived quantities -------------------------------------------------

    @property
    def n_text_tokens(self) -> int:
        return self.text_vocab_size + 1

    @property
    def card(self) -> int:
        """Per-codebook output cardinality (reference voicecraft.py:132)."""
        return self.audio_vocab_size + self.n_special

    @property
    def eog_inference(self) -> int:
        return self.eos if self.eos > 0 else self.eog

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.nhead == 0
        return self.d_model // self.nhead

    @property
    def ffn_dim(self) -> int:
        return self.d_model * 4

    def __post_init__(self):
        # token-id layout invariants (reference voicecraft.py:130-135)
        assert self.text_pad_token == self.text_vocab_size
        assert self.empty_token == self.audio_vocab_size
        assert self.eog == self.audio_vocab_size + 1
        assert self.audio_pad_token == self.audio_vocab_size + 2
        if self.eos > 0:
            assert self.eos not in (self.audio_pad_token, self.empty_token)
            assert self.n_special >= 4
        assert self.norm in ("layernorm", "basicnorm", "balancedbasicnorm",
                             "identity"), self.norm
        assert self.ffn_activation in ("relu", "gelu", "doubleswish",
                                       "balanceddoubleswish"), self.ffn_activation
        if self.block == "deepseek_v2":
            self._check_deepseek_v2()
        elif self.block != "voicecraft":
            raise ValueError(f"unknown block {self.block!r}; expected "
                             "'voicecraft' or 'deepseek_v2'")

    def _check_deepseek_v2(self) -> None:
        """What the port's deepseek_v2 block does not implement raises."""
        refused = {
            "q_lora_rank": self.q_lora_rank is not None,
            "scoring_func": self.scoring_func != "softmax",
            "topk_method": self.topk_method != "greedy",
            "n_group / topk_group": self.n_group != 1 or self.topk_group != 1,
            "moe_layer_freq": self.moe_layer_freq != 1,
            "norm_topk_prob": self.norm_topk_prob,
            "routed_scaling_factor": self.routed_scaling_factor != 1,
            "n_mtp": self.n_mtp != 0,
        }
        bad = [k for k, v in refused.items() if v]
        if bad:
            raise ValueError(
                f"block 'deepseek_v2' does not implement {', '.join(bad)}: "
                "the port's block has no q LoRA, softmax scoring with greedy "
                "(not group-limited) top-k whose weights are neither "
                "renormalised nor scaled, an expert layer after every "
                "leading dense layer, and no MTP heads")
        if not 0 < self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError("deepseek_v2: need 0 < num_experts_per_tok <= "
                             "n_routed_experts")
        if not 0 <= self.first_k_dense_replace <= self.num_decoder_layers:
            raise ValueError("deepseek_v2: first_k_dense_replace outside "
                             "[0, num_decoder_layers]")
        if self.qk_rope_head_dim % 2 or self.qk_rope_head_dim <= 0:
            raise ValueError("deepseek_v2: qk_rope_head_dim must be even")

    # ---- (de)serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Build from a dict, tolerating extra keys (e.g. a full reference
        args.pkl namespace dict) and the reference's stringly-typed fields."""
        names = {f.name for f in dataclasses.fields(cls)}
        clean = {}
        for k, v in d.items():
            if k not in names:
                continue
            if k == "audio_vocab_size" and isinstance(v, str):
                v = int(eval(v, {}, {}))  # as reference voicecraft.py:127
            if k == "codebook_weight" and isinstance(v, str):
                v = tuple(float(x) for x in eval(v, {}, {}))
            if k == "codebook_weight" and isinstance(v, list):
                v = tuple(float(x) for x in v)
            clean[k] = v
        return cls(**clean)


@dataclass(frozen=True)
class TrainConfig:
    """Training runtime config (reference config.py:6-35 and the 830M
    recipe's settings)."""

    seed: int = 1
    lr: float = 0.05
    max_num_tokens: int = 100000
    val_max_num_tokens: Optional[int] = None
    num_buckets: int = 6
    weight_decay: float = 1e-2
    warmup_fraction: float = 0.01
    num_steps: Optional[int] = 50000
    gradient_accumulation_steps: int = 1
    early_stop_step: int = 3200
    early_stop_threshold: float = -1.0

    optimizer_name: str = "ScaledAdam"
    reduce_lr_start_step: int = 3000
    pseudo_epoch_size: int = 3000
    reduce_lr_start_epoch: int = 4
    clipping_update_period: int = 600

    # data
    audio_max_length: float = 20.0
    audio_min_length: float = 2.0
    text_max_length: int = 400
    text_min_length: float = 10.0
    pad_x: int = 1
    drop_long: int = 1

    # io
    exp_dir: Optional[str] = None
    dataset_dir: Optional[str] = None
    manifest_name: str = "manifest"
    phn_folder_name: str = "phonemes"
    encodec_folder_name: str = "encodec_16khz_4codebooks"

    tb_write_every_n_steps: int = 100
    print_every_n_steps: int = 400
    val_every_n_steps: int = 800

    # torch.profiler trace dir and the first traced step (3 steps traced)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10

    # ZeRO-1: shard the optimizer moments over the mesh's data axis
    # (parallel/mesh.py zero1_opt_shardings); semantics-identical, 1/dp the
    # optimizer memory per chip.  Only takes effect with a mesh and a
    # recognised optimizer state; set False to force DDP-style replication.
    zero1: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def block_of(cfg) -> str:
    """The decoder block of ``cfg``; a config without the field (the JAX
    package's ``ModelConfig``, which the port also takes) is VoiceCraft's."""
    return getattr(cfg, "block", "voicecraft")


# ---- presets ----------------------------------------------------------------

def giga330M() -> ModelConfig:
    """Small-model preset: the d_model=1024 reading of the giga330M family."""
    return ModelConfig(d_model=1024, audio_embedding_dim=1024, nhead=16,
                       num_decoder_layers=16, text_vocab_size=120,
                       text_pad_token=120)


def giga830M() -> ModelConfig:
    """830M model (reference z_scripts/e830M.sh:34-37,56-60)."""
    return ModelConfig(d_model=2048, audio_embedding_dim=2048, nhead=16,
                       num_decoder_layers=16, text_vocab_size=120,
                       text_pad_token=120)


def giga830M_tts_enhanced() -> ModelConfig:
    """TTS-enhanced 830M (eos=2051, n_special=4, reduced_eog)."""
    return dataclasses.replace(giga830M(), eos=2051, n_special=4,
                               reduced_eog=1)


def tiny_test() -> ModelConfig:
    """Small config for tests: the same token layout, tiny dims."""
    return ModelConfig(
        d_model=64, audio_embedding_dim=64, nhead=4, num_decoder_layers=2,
        text_vocab_size=40, text_pad_token=40, audio_vocab_size=128,
        empty_token=128, eog=129, audio_pad_token=130,
        text_embedding_dropout=0.0, audio_embedding_dropout=0.0,
        text_positional_embedding_dropout=0.0,
        audio_positional_embedding_dropout=0.0, trm_dropout=0.0)


def tiny_test_mtp() -> ModelConfig:
    """tiny_test with 3 MTP head groups."""
    return dataclasses.replace(tiny_test(), n_mtp=3)


def proc50M() -> ModelConfig:
    """~50M-param model with the giga family's token layout."""
    return ModelConfig(d_model=512, audio_embedding_dim=512, nhead=8,
                       num_decoder_layers=8, text_vocab_size=120,
                       text_pad_token=120)


def deepseek_v2_lite() -> ModelConfig:
    """DeepSeek-V2-Lite's decoder (deepseek-ai/DeepSeek-V2-Lite
    config.json) at its published widths and depth on VoiceCraft's
    TTS-enhanced token layout and front end: 27 layers at 2048, 16 heads of
    latent attention (kv_lora_rank 512, no q LoRA, 128 + 64 query/key and
    128 value dims, YaRN factor 40 over 4096), a dense SwiGLU of 10944 in
    layer 0 and 64 routed experts of 1408 (top-6, softmax, not
    renormalised) with 2 shared ones after it."""
    return dataclasses.replace(
        giga830M_tts_enhanced(), block="deepseek_v2", num_decoder_layers=27,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, intermediate_size=10944, moe_intermediate_size=1408,
        n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
        first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000.0,
        yarn_factor=40.0, yarn_original_max_position_embeddings=4096,
        yarn_beta_fast=32.0, yarn_beta_slow=1.0, yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707)


def tiny_test_dsv2() -> ModelConfig:
    """deepseek_v2_lite's block at tiny widths for the CPU tests: 3 layers
    (one dense), 8 experts top-2 with one shared, tiny_test's TTS-enhanced
    token layout."""
    return dataclasses.replace(
        tiny_test(), eos=131, n_special=4, reduced_eog=1, block="deepseek_v2",
        num_decoder_layers=3, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
        moe_intermediate_size=24, n_routed_experts=8, num_experts_per_tok=2,
        n_shared_experts=1, first_k_dense_replace=1, rms_norm_eps=1e-6,
        rope_theta=10000.0, yarn_factor=40.0,
        yarn_original_max_position_embeddings=4096, yarn_beta_fast=32.0,
        yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)


PRESETS = {
    "giga330M": giga330M,
    "giga830M": giga830M,
    "giga830M_TTSEnhanced": giga830M_tts_enhanced,
    "tiny_test": tiny_test,
    "tiny_test_mtp": tiny_test_mtp,
    "proc50M": proc50M,
    "deepseek_v2_lite": deepseek_v2_lite,
    "tiny_test_dsv2": tiny_test_dsv2,
}
