"""Model configuration — one dataclass covers all ten families of the
registry (``repro_torch.configs``).

Families: dense (GQA/MQA transformer, optional sliding window), moe,
ssm (Mamba2/SSD), hybrid (Mamba2 + shared attention), encdec (whisper
backbone, stub audio frontend), vlm (LM backbone + stub patch embeddings).
The port runs all six (``models.model``).

Every field of the reference's dataclass is kept, so the registry's configs
and their ``smoke()`` reductions are the same values in both packages.  The
port adds fields of its own (``PORT_FIELDS``), each defaulting to the
reference's behaviour: ``ssm_groups`` B/C groups of the SSD, and Zamba2's
published hybrid layout (``hybrid_layer_ids``, ``n_mem_blocks``,
``adapter_rank``; ``ssm_models``), which no registry config sets.
``seq_parallel`` places the residual stream on a mesh
(``transformer._seq_parallel``), ``zero1`` the optimizer moments
(``dist.sharding.opt_state_specs``), ``attn_impl`` picks the training
forward's attention route (``attention.flash_attention``; a prefill takes
"scan") and ``remat_policy`` what a remat unit keeps (``layers.remat``).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "PORT_FIELDS"]

# the fields the reference's dataclass lacks; at their defaults every
# config runs the reference's model
PORT_FIELDS = ("ssm_groups", "hybrid_layer_ids", "n_mem_blocks",
               "adapter_rank")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"       # swiglu | geglu (tanh GELU) | geglu_exact
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # sliding-window attention (gemma3): every `global_every`-th layer is
    # global, the rest attend within `window`.
    window: int = 0
    global_every: int = 0
    window_cache: bool = True   # grouped window-sized KV cache for local layers
                                # (False = full-length cache + mask only; the
                                # §Perf baseline)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    expert_dff: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # hybrid (zamba2): one shared attention block applied after every
    # `attn_every` SSM layers.
    attn_every: int = 0

    # enc-dec (whisper): encoder depth and stub-frontend frame count.
    enc_layers: int = 0
    enc_frames: int = 0

    # vlm (internvl): stub patch-embedding prefix length.
    n_patches: int = 0

    # numerics / training
    kv_quant: bool = False      # int8 KV cache (dense/vlm decode; §Perf)
    attn_impl: str = "vjp"      # vjp | unrolled (§Perf baseline) | scan
    dtype: str = "bfloat16"     # compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)
    seq_parallel: bool = False  # Korthikanti-style: residual/norm activations
                                # shard over (model x sequence); AG/RS pairs
                                # replace the TP all-reduce (same bytes, 16x
                                # smaller saved activations)
    zero1: bool = True

    # port only (PORT_FIELDS).  B and C of the SSD in `ssm_groups` groups,
    # each shared by ssm_heads / ssm_groups heads.
    ssm_groups: int = 1
    # Zamba2's published hybrid layout, when `hybrid_layer_ids` is set: the
    # layers at those indices run, before their Mamba2 layer, one of
    # `n_mem_blocks` shared attention+MLP blocks in turn over
    # concat(hidden, embedding), with an MLP adapter of rank `adapter_rank`
    # and a d x d linear of their own (``ssm_models``).  Empty: the
    # `attn_every` layout.
    hybrid_layer_ids: tuple = ()
    n_mem_blocks: int = 0
    adapter_rank: int = 0

    def __post_init__(self):
        # a JSON list (a benchmark's model block) becomes a hashable tuple
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv, 1)

    @property
    def published_hybrid(self) -> bool:
        """Zamba2's published layout (``hybrid_layer_ids`` set)."""
        return bool(self.hybrid_layer_ids)

    def validate(self):
        if self.n_heads and self.n_kv:
            assert self.n_heads % self.n_kv == 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0 and self.d_inner % self.ssm_headdim == 0
            assert self.ssm_groups >= 1 and self.ssm_heads % self.ssm_groups == 0
        assert self.act in ("swiglu", "geglu", "geglu_exact"), self.act
        if self.published_hybrid:
            ids = self.hybrid_layer_ids
            assert self.family == "hybrid" and not self.attn_every
            assert list(ids) == sorted(set(ids)) and 0 <= ids[0]
            assert ids[-1] < self.n_layers, (ids, self.n_layers)
            assert 1 <= self.n_mem_blocks <= len(ids) and self.adapter_rank > 0
            # the attention reads concat(hidden, embedding): 2 d wide
            assert self.n_heads * self.head_dim == 2 * self.d_model
        else:
            assert not (self.n_mem_blocks or self.adapter_rank)
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0 and self.expert_dff > 0
        if self.family == "encdec":
            assert self.enc_layers > 0 and self.enc_frames > 0
        if self.family == "vlm":
            assert self.n_patches > 0
        if self.window:
            assert self.global_every > 0
        return self

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests; the published
        hybrid layout keeps its first two hybrid layers (both blocks of a
        two-block rotation) and the layers up to them."""
        cfg = self._smoke()
        if not self.published_hybrid:
            return cfg
        ids = self.hybrid_layer_ids[:2]
        return dataclasses.replace(
            cfg, n_layers=ids[-1] + 1, hybrid_layer_ids=ids,
            n_mem_blocks=min(self.n_mem_blocks, len(ids)),
            head_dim=2 * cfg.d_model // cfg.n_heads,
            adapter_rank=min(self.adapter_rank, 16))

    def _smoke(self) -> "ModelConfig":
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 * max(self.global_every, self.attn_every, 1)),
            d_model=128,
            n_heads=max(4, min(self.n_heads, 4)),
            n_kv=1 if self.n_kv == 1 else 2,
            head_dim=32,
            d_ff=256,
            vocab=512,
            window=min(self.window, 64) if self.window else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared=min(self.n_shared, 1) if self.n_shared else 0,
            expert_dff=64 if self.expert_dff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 128,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_frames=min(self.enc_frames, 32) if self.enc_frames else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            dtype="float32",
            param_dtype="float32",
            remat=False,
            zero1=False,
        )
