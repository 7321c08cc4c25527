"""The port's configuration (counterpart of `mtasr_tpu/config.py`).

Field names, defaults and the builders follow the JAX package's, which
follow HF's `WavLMConfig` / `LlamaConfig`, so a config moves between the
two by name (`from_fields`) and through the same `config.json`
(`to_json` / `from_json`): every field of the JAX dataclasses is here with
its default. The `decoder_cross_attention_dynamic*` knobs are carried and,
as in the JAX package, used by no model. The JAX package's
backend selectors (`attention_impl`, `conv0_impl`, `conv_impl`,
`decode_attn_impl`, `scan_layers`) are carried for the round trip and
select nothing: the port chooses by the tensor's device. `gelu_impl`
selects WavLM's erf (`models/layers.py::resolve_act`): "fast" the JAX
package's polynomial, "exact" and "auto" the exact erf.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(eq=False)
class WavLMConfig:
    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    feat_extract_activation: str = "gelu"
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    add_adapter: bool = True
    adapter_kernel_size: int = 3
    adapter_stride: int = 2
    num_adapter_layers: int = 3
    output_hidden_size: Optional[int] = None  # defaults to hidden_size
    # SpecAugment: mask indices are drawn on the host (data/specaugment.py);
    # nonzero probabilities give the model its `masked_spec_embed` parameter
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0
    # dropouts, applied in training from an explicit torch.Generator;
    # attention_dropout and layerdrop are read nowhere, as in the JAX package
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.0
    # train the positional conv's weight norm as separate (g, v) parameters
    # (HF WavLM's torch weight_norm); serving fuses them at load
    pos_conv_weight_norm: bool = False
    # recompute each encoder layer in backward (torch.utils.checkpoint)
    remat: bool = False
    # the JAX package's backend selectors (no counterpart here)
    attention_impl: str = "auto"
    scan_layers: bool = False
    conv_impl: str = "xla"
    # the erf of gelu: "fast" the polynomial, "exact" / "auto" the exact erf
    gelu_impl: str = "auto"
    conv0_impl: str = "auto"

    @property
    def out_hidden(self) -> int:
        return self.output_hidden_size or self.hidden_size

    def conv_output_length(self, n_samples: int) -> int:
        """Frame count after the conv feature encoder (320x downsample)."""
        length = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length

    def adapter_output_length(self, n_frames: int,
                              num_layers: Optional[int] = None) -> int:
        """Frame count after `num_layers` adapter conv layers (stride
        `adapter_stride`, kernel `adapter_kernel_size`, padding k // 2)."""
        if num_layers is None:
            num_layers = self.num_adapter_layers
        length = n_frames
        k, s = self.adapter_kernel_size, self.adapter_stride
        for _ in range(num_layers):
            length = (length + 2 * (k // 2) - k) // s + 1
        return length


def wavlm_base_config(**kw) -> WavLMConfig:
    return WavLMConfig(**kw)


def wavlm_large_config(**kw) -> WavLMConfig:
    """WavLM-Large geometry."""
    defaults = dict(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
        intermediate_size=4096, feat_extract_norm="layer", conv_bias=True,
        do_stable_layer_norm=True,
    )
    defaults.update(kw)
    return WavLMConfig(**defaults)


@dataclass(eq=False)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None  # defaults to hidden_size // heads
    hidden_act: str = "silu"
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # llama3-style rope scaling: {"rope_type": "llama3", "factor": 32.0, ...}
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    attention_dropout: float = 0.0     # read nowhere, as in the JAX package
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    bos_token_id: int = 128000
    eos_token_id: int = 128001
    pad_token_id: Optional[int] = None
    # recompute each decoder layer in backward (torch.utils.checkpoint)
    remat: bool = False
    # the JAX package's backend selectors (no counterpart here)
    scan_layers: bool = False
    decode_attn_impl: str = "pallas"
    # DeepSeek-V3's blocks (Moonlight-16B-A3B), the port's own: the JAX
    # package has no such decoder. `kv_lora_rank` set: every layer's
    # attention is multi-head latent attention (`models/mla.py`) over a
    # cache of kv_lora_rank + qk_rope_head_dim values a slot;
    # `n_routed_experts` set: layers from `first_k_dense_replace` on are
    # mixtures of experts (`models/moe.py`). Unset (the defaults), the
    # decoder is the LLaMA block and these keys are read by nothing.
    # `check_deepseek` refuses by name what the port does not implement.
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: Optional[int] = None
    num_experts_per_tok: int = 8
    n_shared_experts: int = 1
    moe_intermediate_size: int = 2048
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1

    def __post_init__(self):
        check_deepseek(self)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def moe_layer(self, idx: int) -> bool:
        """Whether decoder layer `idx` is a mixture of experts."""
        return (self.n_routed_experts is not None
                and idx >= self.first_k_dense_replace)


# the port's decoder fields that the JAX package's LlamaConfig lacks (its
# defaults stand for them when a JAX config is read, and `to_json` leaves
# out those still at their defaults, so a LLaMA config.json reads in both)
DEEPSEEK_FIELDS = (
    "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
    "v_head_dim", "n_routed_experts", "num_experts_per_tok",
    "n_shared_experts", "moe_intermediate_size", "first_k_dense_replace",
    "routed_scaling_factor", "norm_topk_prob", "scoring_func",
    "topk_method", "n_group", "topk_group")


def check_deepseek(cfg: LlamaConfig) -> None:
    """Refuse, by name, a DeepSeek-V3 setting the port does not implement:
    the q-LoRA branch, a score other than the sigmoid, a top-k other than
    `noaux_tc` over one group, rope scaling (the source's mscale) under
    latent attention."""
    err = []
    if cfg.kv_lora_rank is not None:
        if cfg.q_lora_rank is not None:
            err.append(f"q_lora_rank={cfg.q_lora_rank} (the q-LoRA branch "
                       "is not implemented; null projects q directly)")
        if cfg.rope_scaling is not None:
            err.append("rope_scaling under latent attention (its mscale "
                       "is not implemented)")
    if cfg.n_routed_experts is not None:
        if cfg.scoring_func != "sigmoid":
            err.append(f"scoring_func={cfg.scoring_func!r} (only "
                       "'sigmoid' is implemented)")
        if cfg.topk_method != "noaux_tc":
            err.append(f"topk_method={cfg.topk_method!r} (only "
                       "'noaux_tc' is implemented)")
        if cfg.n_group != 1 or cfg.topk_group != 1:
            err.append(f"n_group={cfg.n_group}, topk_group="
                       f"{cfg.topk_group} (group-limited routing is not "
                       "implemented; both must be 1)")
        if not 0 < cfg.num_experts_per_tok <= cfg.n_routed_experts:
            err.append(f"num_experts_per_tok={cfg.num_experts_per_tok} "
                       f"not in 1..{cfg.n_routed_experts}")
    if err:
        raise ValueError("unsupported decoder config:\n  - "
                         + "\n  - ".join(err))


def llama_1b_config(**kw) -> LlamaConfig:
    """LLaMA-3.2-1B geometry."""
    defaults = dict(
        hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, head_dim=64,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192},
        tie_word_embeddings=True,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def llama_3b_config(**kw) -> LlamaConfig:
    """LLaMA-3.2-3B geometry."""
    defaults = dict(
        hidden_size=3072, intermediate_size=8192, num_hidden_layers=28,
        num_attention_heads=24, num_key_value_heads=8, head_dim=128,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192},
        tie_word_embeddings=True,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def llama_8b_config(**kw) -> LlamaConfig:
    """LLaMA-3.1-8B geometry."""
    defaults = dict(
        hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192},
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def moonlight_16b_a3b_config(**kw) -> LlamaConfig:
    """Moonlight-16B-A3B's decoder geometry (DeepSeek-V3's blocks:
    latent attention, 64 sigmoid-routed experts from layer 1; the port's
    own, the JAX package has no such decoder)."""
    defaults = dict(
        vocab_size=163840, hidden_size=2048, intermediate_size=11264,
        num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=8192, rope_theta=50000.0,
        kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64,
        num_experts_per_tok=6, n_shared_experts=2, moe_intermediate_size=1408,
        first_k_dense_replace=1, routed_scaling_factor=2.446,
        norm_topk_prob=True, scoring_func="sigmoid", topk_method="noaux_tc",
        n_group=1, topk_group=1)
    defaults.update(kw)
    return LlamaConfig(**defaults)


@dataclass(eq=False)
class SpeechEncoderDecoderConfig:
    encoder: WavLMConfig = field(default_factory=WavLMConfig)
    decoder: LlamaConfig = field(default_factory=LlamaConfig)

    pad_token_id: int = 128256
    sc_token_id: int = 128257          # <sc> speaker change
    ignore_token_id: int = -100
    decoder_start_token_id: int = 128000  # BOS
    eos_token_id: int = 128001
    bos_token_id: int = 128000
    # instruct-mode special tokens
    instruct: bool = False
    bosp_token_id: int = 128258        # <bos_prompt>
    eosp_token_id: int = 128259        # <eos_prompt>
    boss_token_id: int = 128260        # <bos_speech>
    eoss_token_id: int = 128261        # <eos_speech>
    bosr_token_id: int = 128262        # <bos_response>
    eosr_token_id: int = 128263        # <eos_response>

    # mode switches
    train_mode: str = "attention"      # ctc | attention | hybrid
    talker_ctc: bool = False           # separator + K serialized-CTC heads
    talker_numbers: int = 2            # <sc>-separated talkers in a label
    separator_hidden: int = 896
    # dropout after each separator LSTM layer, in training only
    separator_dropout: float = 0.2
    talker_ctc_refine: bool = False
    ctc_bridge: bool = False
    ctc_bridge_type: str = "raw"       # raw | softmax | ctcprompt
    ctc_alpha: float = 0.7
    # the cross-attention adapter family; the dynamic* knobs are inert, as
    # in the JAX package
    decoder_cross_attention: bool = False
    decoder_cross_attention_type: str = "tiny"
    decoder_cross_attention_feature: str = "raw"
    decoder_cross_attention_dynamic: bool = False
    decoder_cross_attention_dynamic_threshold: float = 0.0
    decoder_cross_attention_dynamic_loss: bool = False
    decoder_cross_attention_dynamic_ratio: float = 0.8
    cross_attn_dim: int = 512
    r_max: int = 16
    lora_alpha: int = 16
    # dropout on the decoder LoRA branch's input, in training only
    lora_dropout: float = 0.1
    # the generation length a created model directory records
    max_length: int = 200

    def validate(self) -> None:
        """Reject a config no model can have."""
        err = []
        if self.train_mode not in ("ctc", "attention", "hybrid"):
            err.append(f"train_mode={self.train_mode!r} not in "
                       "ctc/attention/hybrid")
        if self.ctc_bridge_type not in ("raw", "softmax", "ctcprompt"):
            err.append(f"ctc_bridge_type={self.ctc_bridge_type!r} invalid")
        if self.decoder_cross_attention_type not in (
                "tiny", "gatetiny", "ctcaware", "adapgatetiny"):
            err.append(f"decoder_cross_attention_type="
                       f"{self.decoder_cross_attention_type!r} invalid")
        if self.decoder_cross_attention_feature not in (
                "raw", "mix", "sep", "ctctoken"):
            err.append(f"decoder_cross_attention_feature="
                       f"{self.decoder_cross_attention_feature!r} invalid")
        needs_ctc = []
        if self.train_mode in ("ctc", "hybrid"):
            needs_ctc.append(f"train_mode={self.train_mode}")
        if self.ctc_bridge:
            needs_ctc.append("ctc_bridge")
        if self.talker_ctc_refine:
            needs_ctc.append("talker_ctc_refine")
        if (self.decoder_cross_attention
                and self.decoder_cross_attention_feature in ("sep",
                                                             "ctctoken")):
            needs_ctc.append("decoder_cross_attention_feature="
                             + self.decoder_cross_attention_feature)
        if (self.decoder_cross_attention
                and self.decoder_cross_attention_type == "ctcaware"):
            needs_ctc.append("decoder_cross_attention_type=ctcaware")
        if needs_ctc and not self.talker_ctc:
            err.append(f"{', '.join(needs_ctc)} require(s) talker_ctc=True "
                       "(separator + serialized CTC heads)")
        if self.talker_ctc and self.talker_numbers < 2:
            err.append("talker_numbers must be >= 2 with talker_ctc")
        if self.instruct:
            specials = (self.bosp_token_id, self.eosp_token_id,
                        self.boss_token_id, self.eoss_token_id,
                        self.bosr_token_id, self.eosr_token_id)
            if any(s is None or s < 0 for s in specials):
                err.append("instruct=True requires all six instruct special "
                           "token ids")
            elif max(specials) >= self.decoder.vocab_size:
                err.append(f"instruct special id {max(specials)} >= decoder "
                           f"vocab {self.decoder.vocab_size}; resize vocab")
        if err:
            raise ValueError("invalid SpeechEncoderDecoderConfig:\n  - "
                             + "\n  - ".join(err))

    @property
    def ctc_blank_id(self) -> int:
        """The CTC heads' blank: odim = decoder vocab + 1, blank = odim - 1."""
        return self.decoder.vocab_size

    @property
    def ctc_odim(self) -> int:
        return self.decoder.vocab_size + 1

    def to_json(self) -> str:
        """The JAX package's `config.json` text (and the port's
        `DEEPSEEK_FIELDS` that are not at their defaults)."""
        d = dataclasses.asdict(self)
        defaults = LlamaConfig()
        for name in DEEPSEEK_FIELDS:
            if d["decoder"][name] == getattr(defaults, name):
                del d["decoder"][name]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SpeechEncoderDecoderConfig":
        d = json.loads(s)
        enc = WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in d.pop("encoder").items()})
        dec = LlamaConfig(**d.pop("decoder"))
        return cls(encoder=enc, decoder=dec, **d)


@dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 150          # new-token budget
    max_new_tokens: Optional[int] = None
    num_beams: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    use_cache: bool = True         # read by no route, as in the JAX package
    # int8 KV cache (per-(row, slot, head) scales)
    kv_quant: bool = False
    # encode the batch this many rows at a time (None: all at once)
    encode_chunk: Optional[int] = None
    # "ctc": speculative greedy decoding drafted by the CTC heads
    speculative: Optional[str] = None
    spec_k: int = 4
    spec_cache_factor: float = 2.0


@dataclass
class DataConfig:
    dataset_name: Optional[str] = None
    audio_column_name: str = "audio"
    text_column_name: str = "text"
    max_duration_in_seconds: float = 20.0
    min_duration_in_seconds: float = 0.0
    do_lower_case: bool = True
    sampling_rate: int = 16000
    train_split_name: str = "train"
    eval_split_name: str = "test"
    # audio length buckets: a batch is padded to its bucket's length
    bucket_boundaries_seconds: Tuple[float, ...] = (5.0, 10.0, 15.0, 20.0)
    max_label_length: int = 256


@dataclass
class TrainingConfig:
    """The HF Seq2SeqTrainingArguments subset the JAX package's trainer
    reads (same names and defaults)."""
    output_dir: str = "exp/run"
    learning_rate: float = 3e-5
    warmup_steps: int = 400
    max_steps: int = 100_000
    num_train_epochs: float = 30.0
    per_device_train_batch_size: int = 12
    per_device_eval_batch_size: int = 12
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    lr_scheduler_type: str = "linear"
    logging_steps: int = 25
    eval_steps: int = 1600
    save_steps: int = 1600
    save_total_limit: int = 5
    seed: int = 42
    bf16: bool = True
    gradient_checkpointing: bool = False
    metric_for_best_model: str = "eval_loss"
    greater_is_better: bool = False
    load_best_model_at_end: bool = True
    pcgrad: bool = True
    dp_size: int = -1
    tp_size: int = 1
    resume_from_checkpoint: Optional[str] = None


_NESTED = {"encoder": WavLMConfig, "decoder": LlamaConfig}


def from_fields(cls, obj):
    """An instance of the port's config class `cls` whose fields are read
    from `obj` by name: a config of the JAX package, or any object with
    the same attribute names. Fields the port does not have are left
    behind; a field the port has and `obj` lacks raises AttributeError,
    except the decoder's `DEEPSEEK_FIELDS`, which take their defaults."""
    kw = {}
    for f in dataclasses.fields(cls):
        if cls is LlamaConfig and f.name in DEEPSEEK_FIELDS \
                and not hasattr(obj, f.name):
            continue
        value = getattr(obj, f.name)
        if f.name in _NESTED:
            value = from_fields(_NESTED[f.name], value)
        elif isinstance(value, dict):
            value = dict(value)
        kw[f.name] = value
    return cls(**kw)
