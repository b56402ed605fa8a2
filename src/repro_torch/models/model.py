"""The LM as pre-norm residual blocks, and its serving forwards.

The port of ``repro.models.model`` for the blocks it has so far:
signatures ``("attn", "dense")`` (GQA softmax attention, then a
SwiGLU/GeGLU/GELU MLP) and ``("nfft", "dense")`` (the paper's NFFT kernel
attention, :mod:`repro_torch.models.nfft_attention`, then the MLP), token
inputs, a tied or separate LM head.  The other mixers (MLA, Mamba),
mixture of experts, the modality frontends and the training forward wait
(ROADMAP queue 1 item 13) and raise ``NotImplementedError``.

The JAX package runs its layer plan's periodic part under ``lax.scan`` over
period-stacked parameters; here the blocks are a plain list in layer order
(:func:`params_from_arrays` unstacks a JAX tree onto it).  Caches are one
per layer, updated in place: a :class:`~repro_torch.models.attention.
KVCache` for an attention layer, an :class:`~repro_torch.models.
nfft_attention.NFFTCache` for an NFFT layer.

    forward_prefill (tokens, caches)     -> (logits_last, caches)
    forward_decode  (token, pos, caches) -> (logits, caches)   # 1 token
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.common import (
    dense_init, embed_init, init_rms_norm, rms_norm,
)
from repro_torch.models.mlp import MLP
from repro_torch.models.nfft_attention import NFFTAttention, init_nfft_cache

_PORTED = (("attn", "dense"), ("nfft", "dense"))
_TODO = "not ported yet (ROADMAP queue 1 item 13)"


# ---------------------------------------------------------------------------
# Layer plan (as the JAX package's)
# ---------------------------------------------------------------------------

class LayerSig(NamedTuple):
    mixer: str  # 'attn' | 'mla' | 'mamba' | 'nfft'
    ffn: Optional[str]  # 'dense' | 'moe' | None


class LayerPlan(NamedTuple):
    prefix: tuple[LayerSig, ...]  # explicit leading layers
    period: tuple[LayerSig, ...]  # repeating pattern
    n_periods: int

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.period) * self.n_periods


def layer_signature(cfg: ArchConfig, i: int) -> LayerSig:
    if cfg.is_attention_layer(i):
        if cfg.nfft_attention is not None:
            mixer = "nfft"
        elif cfg.mla is not None:
            mixer = "mla"
        else:
            mixer = "attn"
    else:
        mixer = "mamba"
    if cfg.is_moe_layer(i):
        ffn = "moe"
    elif cfg.d_ff > 0:
        ffn = "dense"
    else:
        ffn = None
    return LayerSig(mixer, ffn)


def make_layer_plan(cfg: ArchConfig, max_period: int = 16) -> LayerPlan:
    """Smallest (prefix, period) decomposition of the signature sequence."""
    sigs = tuple(layer_signature(cfg, i) for i in range(cfg.num_layers))
    n = len(sigs)
    for p_len in range(0, n + 1):
        rest = sigs[p_len:]
        if not rest:
            return LayerPlan(prefix=sigs, period=(), n_periods=0)
        for period in range(1, min(max_period, len(rest)) + 1):
            if len(rest) % period != 0:
                continue
            pat = rest[:period]
            if all(rest[j] == pat[j % period] for j in range(len(rest))):
                return LayerPlan(prefix=sigs[:p_len], period=pat,
                                 n_periods=len(rest) // period)
    return LayerPlan(prefix=sigs, period=(), n_periods=0)  # pragma: no cover


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is {_TODO}")
    for i in range(cfg.num_layers):
        sig = layer_signature(cfg, i)
        if tuple(sig) not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is {tuple(sig)}; only "
                f"{' and '.join(map(str, _PORTED))} blocks are ported, the "
                f"rest is {_TODO}")


# ---------------------------------------------------------------------------
# Blocks and the model
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One residual block: x + mixer(norm(x)), then x + mlp(norm(x)).  The
    mixer is ``attn`` (GQA) or ``nfft`` (NFFT kernel attention, which
    ignores positions, the prefix length and ``use_flash``, as the JAX
    package's does)."""

    def __init__(self, cfg: ArchConfig, mixer: str, *, generator, device):
        super().__init__()
        self.cfg = cfg
        self.norm_mixer = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        if mixer == "nfft":
            self.nfft = NFFTAttention(cfg, generator=generator,
                                      device=device)
        else:
            self.attn = Attention(cfg, generator=generator, device=device)
        self.norm_ffn = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, cfg.pdtype,
                       generator=generator, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                mode: str, cache=None, use_flash: bool = False,
                prefix_len: int = 0) -> torch.Tensor:
        """mode 'train' (whole sequence, no cache), 'prefill' or 'decode'."""
        h = rms_norm(x, self.norm_mixer, self.cfg.norm_eps)
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if hasattr(self, "nfft"):
            mix = (self.nfft(h) if mode == "train" else
                   getattr(self.nfft, mode)(h, cache))
        elif mode == "train":
            mix = self.attn(h, positions, use_flash=use_flash,
                            prefix_len=prefix_len)
        elif mode == "prefill":
            mix = self.attn.prefill(h, positions, cache, use_flash=use_flash,
                                    prefix_len=prefix_len)
        else:
            mix = self.attn.decode(h, positions, cache)
        x = x + mix
        return x + self.mlp(rms_norm(x, self.norm_ffn, self.cfg.norm_eps))


class Model(nn.Module):
    """``init_params``' tree as a module: ``embed`` (V, d), ``blocks`` in
    layer order, ``final_norm``, and ``lm_head`` (d, V) unless the head is
    tied to the embedding."""

    def __init__(self, cfg: ArchConfig, *, generator, device):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = embed_init((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                **kw)
        self.blocks = nn.ModuleList(
            Block(cfg, layer_signature(cfg, i).mixer, **kw)
            for i in range(cfg.num_layers))
        self.final_norm = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = dense_init((cfg.d_model, cfg.vocab_size),
                                      cfg.pdtype, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.embedding_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=self.cfg.dtype, device=x.device)
        return x.to(self.cfg.dtype)

    def embed_inputs(self, batch: dict):
        """Token path of ``embed_inputs``: (x (b, s, d), positions (b, s),
        prefix_len)."""
        x = self.embed_tokens(batch["tokens"])
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions, 0

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        logits = h @ (self.embed.T if self.lm_head is None else self.lm_head)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    def run_backbone(self, x: torch.Tensor, positions: torch.Tensor, *,
                     mode: str, caches: Optional[list] = None,
                     use_flash: bool = False,
                     prefix_len: int = 0) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x, positions, mode=mode,
                      cache=None if caches is None else caches[i],
                      use_flash=use_flash, prefix_len=prefix_len)
        return x

    def forward_prefill(self, batch: dict, caches: list, *,
                        use_flash: Optional[bool] = None):
        """Process the full prompt; returns (last-position logits (b, 1, V),
        caches), the caches filled in place.  ``use_flash=None`` means the
        flash kernel on a CUDA card and the einsum on the CPU."""
        x, positions, prefix_len = self.embed_inputs(batch)
        if use_flash is None:
            use_flash = x.device.type == "cuda"
        h = self.run_backbone(x, positions, mode="prefill", caches=caches,
                              use_flash=use_flash, prefix_len=prefix_len)
        return self.lm_logits(h[:, -1:, :]), caches

    def forward_decode(self, token: torch.Tensor, pos: torch.Tensor,
                       caches: list):
        """One decode step.  token (b, 1) integers; pos (b,) current
        positions.  Returns (logits (b, 1, V), caches)."""
        x = self.embed_tokens(token)
        h = self.run_backbone(x, pos, mode="decode", caches=caches)
        return self.lm_logits(h), caches


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> Model:
    """A model with random weights from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default: the CUDA card).  Weights are drawn in
    float32 and cast, so two dtypes of one config from one seed hold the
    same weights up to rounding."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, generator=gen, device=dev)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                device: str | torch.device | None = None) -> list:
    """One cache per layer: a KV cache of ``max_seq`` rows for an attention
    layer, the constant-size (S, z) for an NFFT layer."""
    dev = resolve_device(device)
    return [init_nfft_cache(cfg, batch, device=dev)
            if layer_signature(cfg, i).mixer == "nfft"
            else init_kv_cache(cfg, batch, max_seq, device=dev)
            for i in range(cfg.num_layers)]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_arrays(tree: dict, cfg: ArchConfig, *,
                       device: str | torch.device | None = None) -> Model:
    """The port's model from a JAX parameter tree (``repro.models.model.
    init_params``' output, leaves as numpy arrays).

    ``prefix[i]`` becomes layer i; a ``stack[slot]`` leaf of shape
    (n_periods, ...) is unstacked onto layers
    ``len(prefix) + p * len(period) + slot``.
    """
    dev = resolve_device(device)
    plan = make_layer_plan(cfg)
    with torch.device("meta"):
        model = Model(cfg, generator=None, device="meta")
    model = model.to_empty(device=dev)
    state = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if "lm_head" in tree:
        state["lm_head"] = tree["lm_head"]
    for i, block in enumerate(tree.get("prefix", [])):
        for name, leaf in _flatten(block):
            state[f"blocks.{i}.{name}"] = leaf
    for slot, stacked in enumerate(tree.get("stack", [])):
        for name, leaf in _flatten(stacked):
            leaf = np.asarray(leaf)
            for p in range(plan.n_periods):
                layer = len(plan.prefix) + p * len(plan.period) + slot
                state[f"blocks.{layer}.{name}"] = leaf[p]
    model.load_state_dict({k: _tensor(v) for k, v in state.items()},
                          strict=True)
    return model
