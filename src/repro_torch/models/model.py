"""The LM as pre-norm residual blocks, and its serving forwards.

The port of ``repro.models.model`` for the blocks it has so far:
signatures ``("attn", "dense")`` (GQA softmax attention, then a
SwiGLU/GeGLU/GELU MLP) and ``("nfft", "dense")`` (the paper's NFFT kernel
attention, :mod:`repro_torch.models.nfft_attention`, then the MLP), token
inputs, a tied or separate LM head.  The other mixers (MLA, Mamba),
mixture of experts, multi-token prediction and the modality frontends wait
(ROADMAP queue 1 item 13c) and raise ``NotImplementedError``.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.common import (
    dense_init, embed_init, init_rms_norm, rms_norm,
)
from repro_torch.models.mlp import MLP
from repro_torch.models.nfft_attention import NFFTAttention, init_nfft_cache
from repro_torch.tree import tree_leaves

_PORTED = (("attn", "dense"), ("nfft", "dense"))
_TODO = "not ported yet (ROADMAP queue 1 item 13c)"


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
        self.leaf_tree = None  # set by stack_for_training
        self.leaf_members = None

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

    @torch.no_grad()
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

    @torch.no_grad()
    def forward_decode(self, token: torch.Tensor, pos: torch.Tensor,
                       caches: list):
        """One decode step.  token (b, 1) integers; pos (b,) current
        positions.  Returns (logits (b, 1, V), caches)."""
        x = self.embed_tokens(token)
        h = self.run_backbone(x, pos, mode="decode", caches=caches)
        return self.lm_logits(h), caches

    # -- training ----------------------------------------------------------
    def _loss(self, h: torch.Tensor, batch: dict) -> torch.Tensor:
        """The next-token loss of the token path: labels[t] = tokens[t+1],
        ``loss_mask`` (default all ones) selecting the counted
        positions."""
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        return cross_entropy(self.lm_logits(h), labels, mask)

    def forward_train(self, batch: dict, *, remat: bool = True):
        """``forward_train``: tokens and labels (b, s), optional
        ``loss_mask`` -> (loss, metrics ``ce_loss``, ``aux_loss``,
        ``loss``).  With ``remat`` and a gradient wanted, each block is
        recomputed in the backward (``torch.utils.checkpoint``, one
        boundary per block where the JAX package has one per period).
        Attention is the einsum: the flash kernel has no backward."""
        if self.cfg.mtp_depth > 0:
            raise NotImplementedError(
                f"{self.cfg.name}: multi-token prediction chains an MLA/MoE "
                f"block, which is {_TODO}")
        x, positions, prefix_len = self.embed_inputs(batch)
        for block in self.blocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, x, positions, mode="train",
                               prefix_len=prefix_len, use_reentrant=False)
            else:
                x = block(x, positions, mode="train", prefix_len=prefix_len)
        loss = self._loss(x, batch)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"ce_loss": loss, "aux_loss": aux, "loss": loss}

    def forward_train_reference(self, batch: dict):
        """``forward_train_reference``: the plain layer loop, no remat."""
        x, positions, prefix_len = self.embed_inputs(batch)
        for block in self.blocks:
            x = block(x, positions, mode="train", prefix_len=prefix_len)
        loss = self._loss(x, batch)
        return loss, {"loss": loss}

    def stack_for_training(self) -> dict:
        """Make every parameter trainable and return the JAX package's
        parameter tree over the model's storage (``init_params``'
        structure; the first call builds it).

        The layers of each ``stack[slot]`` leaf go into one tensor of shape
        (n_periods, ...), of which each layer's parameter becomes a view,
        so an update of the stacked tensor is an update of the layers.
        ``leaf_members`` lists, leaf by leaf in the tree's order, the
        parameters each leaf holds: the layers of a stacked leaf in period
        order, or the one parameter that is the leaf."""
        if self.leaf_tree is not None:
            return self.leaf_tree
        plan = make_layer_plan(self.cfg)
        self.requires_grad_(True)
        tree = {"embed": self.embed, "final_norm": self.final_norm}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        if plan.prefix:
            tree["prefix"] = [_nest(self.blocks[i].named_parameters())
                              for i in range(len(plan.prefix))]
        members = {}
        if plan.n_periods:
            tree["stack"] = []
            for slot in range(len(plan.period)):
                layers = [self.blocks[len(plan.prefix)
                                      + p * len(plan.period) + slot]
                          for p in range(plan.n_periods)]
                stacked = {}
                for name, _ in list(layers[0].named_parameters()):
                    leaf = torch.stack([blk.get_parameter(name).detach()
                                        for blk in layers])
                    views = []
                    for blk, view in zip(layers, leaf):
                        owner, _, attr = name.rpartition(".")
                        views.append(nn.Parameter(view))
                        setattr(blk.get_submodule(owner), attr, views[-1])
                    members[id(leaf)] = tuple(views)
                    stacked[name] = leaf
                tree["stack"].append(_nest(stacked.items()))
        self.leaf_tree = tree
        self.leaf_members = [members.get(id(leaf), (leaf,))
                             for leaf in tree_leaves(tree)]
        return tree


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Stable cross entropy in float32: the mean negative log-likelihood
    over the positions ``mask`` selects."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _nest(named) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    tree: dict = {}
    for name, leaf in named:
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


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
