"""The LM as pre-norm residual blocks: its training loss and its serving
forwards, for every registered architecture.

The port of ``repro.models.model``.  A block has a mixer, ``attn`` (GQA
softmax attention), ``mla`` (DeepSeek latent attention), ``mamba`` (Mamba2
SSD) or ``nfft`` (the paper's NFFT kernel attention), and an ffn,
``dense`` (SwiGLU/GeGLU/GELU), ``moe`` or none (pure-SSM blocks).  Inputs
are tokens, or for the modality stubs precomputed embeddings through one
linear projection: hubert's audio frames, paligemma's image patches in
front of its tokens (a bidirectional prefix).  DeepSeek's multi-token
prediction chains one extra block per depth in the training loss.

The JAX package runs its layer plan's periodic part under ``lax.scan`` over
period-stacked parameters; here the blocks are a plain list in layer order
(:func:`params_from_arrays` unstacks a JAX tree onto it).  Caches are one
per layer, updated in place: a :class:`~repro_torch.models.attention.
KVCache` for an attention layer, an :class:`~repro_torch.models.attention.
MLACache` for MLA, a :class:`~repro_torch.models.mamba.MambaCache` for
Mamba, an :class:`~repro_torch.models.nfft_attention.NFFTCache` for NFFT.

    forward_train   (tokens/embeds, labels)  -> (loss, metrics)
    forward_prefill (tokens/embeds, caches)  -> (logits_last, caches)
    forward_decode  (token, pos, caches)     -> (logits, caches)   # 1 token
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
from repro_torch.launch.mesh import block_range
from repro_torch.models.attention import (
    MLA, Attention, init_kv_cache, init_mla_cache,
)
from repro_torch.models.common import (
    batch_sum, dense_init, embed_init, init_rms_norm, model_block,
    model_copy, model_gather, model_max, model_split, model_sum, rms_norm,
)
from repro_torch.models.mamba import Mamba, init_mamba_cache
from repro_torch.models.mlp import MLP, MoE
from repro_torch.models.nfft_attention import NFFTAttention, init_nfft_cache
from repro_torch.tree import tree_leaves


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


# ---------------------------------------------------------------------------
# Blocks and the model
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``_init_block`` / ``_apply_block``: x + mixer(norm(x)), then, unless
    the block is a pure-SSM one (``ffn`` None, no ``norm_ffn``),
    x + ffn(norm(x)).  The mixer is ``attn`` (GQA), ``mla`` (DeepSeek
    latent attention), ``mamba`` (Mamba2 SSD) or ``nfft`` (NFFT kernel
    attention); the ffn ``mlp`` (dense) or ``moe``.  Only ``attn`` reads
    ``use_flash`` and the prefix length; ``mamba`` and ``nfft`` ignore the
    positions, as the JAX package's do."""

    def __init__(self, cfg: ArchConfig, sig: LayerSig, *, generator,
                 device):
        super().__init__()
        self.cfg, self.sig = cfg, sig
        kw = dict(generator=generator, device=device)
        self.norm_mixer = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        mixers = {"attn": Attention, "mla": MLA, "mamba": Mamba,
                  "nfft": NFFTAttention}
        setattr(self, sig.mixer, mixers[sig.mixer](cfg, **kw))
        if sig.ffn is not None:
            self.norm_ffn = init_rms_norm(cfg.d_model, cfg.pdtype, device)
            if sig.ffn == "moe":
                self.moe = MoE(cfg, **kw)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation,
                               cfg.pdtype, **kw)

    def _mix(self, h, positions, mode, cache, use_flash, prefix_len):
        mixer = getattr(self, self.sig.mixer)
        if self.sig.mixer == "attn":
            if mode == "train":
                return mixer(h, positions, use_flash=use_flash,
                             prefix_len=prefix_len)
            if mode == "prefill":
                return mixer.prefill(h, positions, cache,
                                     use_flash=use_flash,
                                     prefix_len=prefix_len)
            return mixer.decode(h, positions, cache)
        if self.sig.mixer == "mla":
            if mode == "train":
                return mixer(h, positions)
            return getattr(mixer, mode)(h, positions, cache)
        # mamba and nfft: no positions
        return mixer(h) if mode == "train" else getattr(mixer, mode)(h, cache)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                mode: str, cache=None, use_flash: bool = False,
                prefix_len: int = 0):
        """mode 'train' (whole sequence, no cache), 'prefill' or 'decode'
        (the cache updated in place).  Returns (x, the block's float32 aux
        loss: the MoE's, else 0)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        h = rms_norm(x, self.norm_mixer, self.cfg.norm_eps)
        x = x + self._mix(h, positions, mode, cache, use_flash, prefix_len)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.sig.ffn is None:
            return x, aux
        h = rms_norm(x, self.norm_ffn, self.cfg.norm_eps)
        if self.sig.ffn == "moe":
            out, aux = self.moe(h)
        else:
            out = self.mlp(h)
        return x + out, aux


class MTPLayer(nn.Module):
    """One multi-token-prediction depth of ``init_params``: ``combine``
    (2d, d), ``norm_h``, ``norm_e`` and a ``block`` of the last layer's
    signature."""

    def __init__(self, cfg: ArchConfig, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.combine = dense_init((2 * cfg.d_model, cfg.d_model), cfg.pdtype,
                                  **kw)
        self.norm_h = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.norm_e = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.block = Block(cfg, layer_signature(cfg, cfg.num_layers - 1),
                           **kw)


class Model(nn.Module):
    """``init_params``' tree as a module: ``embed`` (V, d) unless the
    frontend is the audio stub, ``frontend_proj`` (frontend_dim, d) with a
    frontend, ``blocks`` in layer order, ``final_norm``, ``lm_head`` (d, V)
    when the head is untied or the frontend is audio, and ``mtp``, one
    :class:`MTPLayer` per multi-token-prediction depth."""

    def __init__(self, cfg: ArchConfig, *, generator, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = None
        if cfg.frontend in ("none", "vision_stub"):
            self.embed = embed_init((cfg.vocab_size, cfg.d_model),
                                    cfg.pdtype, **kw)
        if cfg.frontend != "none":
            self.frontend_proj = dense_init((cfg.frontend_dim, cfg.d_model),
                                            cfg.pdtype, **kw)
        self.blocks = nn.ModuleList(
            Block(cfg, layer_signature(cfg, i), **kw)
            for i in range(cfg.num_layers))
        self.final_norm = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.lm_head = None
        if not cfg.tie_embeddings or cfg.frontend == "audio_stub":
            self.lm_head = dense_init((cfg.d_model, cfg.vocab_size),
                                      cfg.pdtype, **kw)
        self.mtp = nn.ModuleList(MTPLayer(cfg, **kw)
                                 for _ in range(cfg.mtp_depth))
        self.leaf_tree = None  # set by stack_for_training
        self.leaf_members = None
        # (block, x, positions, remat=False, **Block.forward's keywords)
        # -> (x, aux): how the forwards run a block; None runs it on its
        # own weights (the sharded steps gather them on use)
        self.block_call = None

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.embedding_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=self.cfg.dtype, device=x.device)
        return x.to(self.cfg.dtype)

    def embed_inputs(self, batch: dict):
        """``embed_inputs``: (x (b, s, d), positions (b, s), prefix_len).
        Tokens; the audio stub's frame embeddings ``embeds`` through
        ``frontend_proj``; or the vision stub's ``image_embeds`` through
        it, followed by the (scaled) token embeddings, with the image as
        a bidirectional prefix of ``num_prefix_embeds`` positions."""
        cfg = self.cfg
        prefix_len = 0
        if cfg.frontend == "audio_stub":
            x = batch["embeds"].to(cfg.dtype) @ self.frontend_proj
        elif cfg.frontend == "vision_stub":
            img = batch["image_embeds"].to(cfg.dtype) @ self.frontend_proj
            x = torch.cat([img, self.embed_tokens(batch["tokens"])], dim=1)
            prefix_len = cfg.num_prefix_embeds
        else:
            x = self.embed_tokens(batch["tokens"])
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x.to(cfg.dtype), positions, prefix_len

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The logits of h; under a model split, of this rank's ceil block
        of the vocabulary (``block_range``): the tied ``embed``'s rows of
        it, or ``lm_head``, which the sharded step hands over as the block
        of its columns."""
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        if model_split()[1] > 1:
            w = model_block(self.embed, 0).T if self.lm_head is None \
                else self.lm_head
            logits = model_copy(h) @ w
        else:
            logits = h @ (self.embed.T if self.lm_head is None
                          else self.lm_head)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    def run_backbone(self, x: torch.Tensor, positions: torch.Tensor, *,
                     mode: str, caches: Optional[list] = None,
                     use_flash: bool = False,
                     prefix_len: int = 0) -> torch.Tensor:
        call = self.block_call or (lambda block, x, positions, **kw:
                                   block(x, positions, **kw))
        for i, block in enumerate(self.blocks):
            x, _ = call(block, x, positions, mode=mode,
                        cache=None if caches is None else caches[i],
                        use_flash=use_flash, prefix_len=prefix_len)
        return x

    def _whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Serving's logits over the whole vocabulary: under a model split,
        every rank's ceil block of them gathered (``model_gather``)."""
        if model_split()[1] == 1:
            return logits
        return model_gather(logits, -1, self.cfg.vocab_size)

    @torch.no_grad()
    def forward_prefill(self, batch: dict, caches: list, *,
                        use_flash: Optional[bool] = None):
        """Process the full prompt (``tokens``; ``embeds`` for the audio
        stub; ``image_embeds`` and ``tokens`` for the vision stub); returns
        (last-position logits (b, 1, V), caches), the caches filled in
        place.  ``use_flash=None`` means the flash kernel on a CUDA card and
        the einsum on the CPU (a prefix-LM prefix always takes the
        einsum)."""
        x, positions, prefix_len = self.embed_inputs(batch)
        if use_flash is None:
            use_flash = x.device.type == "cuda"
        h = self.run_backbone(x, positions, mode="prefill", caches=caches,
                              use_flash=use_flash, prefix_len=prefix_len)
        return self._whole_logits(self.lm_logits(h[:, -1:, :])), caches

    @torch.no_grad()
    def forward_decode(self, token: torch.Tensor, pos: torch.Tensor,
                       caches: list):
        """One decode step.  token (b, 1) integers; pos (b,) current
        positions.  Returns (logits (b, 1, V), caches)."""
        x = self.embed_tokens(token)
        h = self.run_backbone(x, pos, mode="decode", caches=caches)
        return self._whole_logits(self.lm_logits(h)), caches

    # -- training ----------------------------------------------------------
    def _loss(self, h: torch.Tensor, batch: dict) -> torch.Tensor:
        """The cross entropy of ``forward_train``: labels (b, s) against
        the logits of h, over the text segment for the vision stub;
        ``loss_mask`` (default all ones) selects the counted positions."""
        if self.cfg.frontend == "vision_stub":
            h = h[:, self.cfg.num_prefix_embeds:]
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        return cross_entropy(self.lm_logits(h), labels, mask,
                             self.cfg.vocab_size)

    def _total(self, h, aux, batch, positions):
        """(loss, metrics) from the backbone's output and summed aux loss:
        the cross entropy, plus ``router_aux_weight · aux`` with MoE, plus
        0.3 of the multi-token-prediction loss with MTP."""
        cfg = self.cfg
        loss = self._loss(h, batch)
        metrics = {"ce_loss": loss, "aux_loss": aux}
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux
        if cfg.mtp_depth > 0 and not cfg.encoder_only:
            mtp_loss = self._mtp_loss(h, batch, positions)
            metrics["mtp_loss"] = mtp_loss
            loss = loss + 0.3 * mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, h, batch, positions) -> torch.Tensor:
        """``_mtp_loss``: depth t predicts token i + t + 1 from (h_i,
        embed(token i + t)), chaining one block per depth; ``labels``
        (tokens shifted by one) is the future-token stream."""
        cfg = self.cfg
        labels = batch["labels"]
        b, s = labels.shape
        loss = torch.zeros((), dtype=torch.float32, device=h.device)
        cur = h
        for t, mtp in enumerate(self.mtp):
            shift = t + 1
            fut_e = self.embed[torch.roll(labels, -t, dims=1)]
            merged = torch.cat([
                rms_norm(cur, mtp.norm_h, cfg.norm_eps),
                rms_norm(fut_e.to(cur.dtype), mtp.norm_e, cfg.norm_eps),
            ], dim=-1) @ mtp.combine
            cur, _ = self._train_block(mtp.block, merged, positions, 0,
                                       remat=False)
            mask = (torch.arange(s, device=h.device)[None, :] < s - shift
                    ).float().expand(b, s)
            loss = loss + cross_entropy(self.lm_logits(cur),
                                        torch.roll(labels, -shift, dims=1),
                                        mask, cfg.vocab_size)
        return loss / max(cfg.mtp_depth, 1)

    def forward_train(self, batch: dict, *, remat: bool = True):
        """``forward_train``: tokens (or the frontends' embeddings) and
        labels (b, s), optional ``loss_mask`` -> (loss, metrics
        ``ce_loss``, ``aux_loss``, ``loss``, and ``mtp_loss`` with MTP).
        With ``remat`` and a gradient wanted, each block is recomputed in
        the backward (``torch.utils.checkpoint``, one boundary per block
        where the JAX package has one per period).  Attention is the
        einsum: the flash kernel has no backward."""
        x, positions, prefix_len = self.embed_inputs(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, a = self._train_block(block, x, positions, prefix_len, remat)
            aux = aux + a
        return self._total(x, aux, batch, positions)

    def _train_block(self, block, x, positions, prefix_len, remat):
        if self.block_call is not None:
            return self.block_call(block, x, positions, remat=remat,
                                   mode="train", prefix_len=prefix_len)
        if remat and torch.is_grad_enabled():
            return checkpoint(block, x, positions, mode="train",
                              prefix_len=prefix_len, use_reentrant=False)
        return block(x, positions, mode="train", prefix_len=prefix_len)

    def forward_train_reference(self, batch: dict):
        """``forward_train_reference``: the plain layer loop, no remat."""
        x, positions, prefix_len = self.embed_inputs(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, a = block(x, positions, mode="train", prefix_len=prefix_len)
            aux = aux + a
        loss, _ = self._total(x, aux, batch, positions)
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
        tree = {"final_norm": self.final_norm}
        for name in ("embed", "frontend_proj", "lm_head"):
            if getattr(self, name, None) is not None:
                tree[name] = getattr(self, name)
        if plan.prefix:
            tree["prefix"] = [_nest(self.blocks[i].named_parameters())
                              for i in range(len(plan.prefix))]
        if len(self.mtp):
            tree["mtp"] = [_nest(m.named_parameters()) for m in self.mtp]
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
                  mask: torch.Tensor,
                  vocab_size: Optional[int] = None) -> torch.Tensor:
    """Stable cross entropy in float32: the mean negative log-likelihood
    over the positions ``mask`` selects (over the whole batch: under a
    mesh whose ranks hold blocks of it, the sum and the count are summed
    over those ranks first).

    Under a model split, ``logits`` is this rank's ceil block of a
    ``vocab_size`` vocabulary (:meth:`Model.lm_logits`): the max, the sum
    of exponentials and the target's logit are reduced over the split
    (a max, and sums whose gradient every rank holds whole); the logits
    are never gathered."""
    logits = logits.float()
    j, m = model_split()
    if m > 1:
        lo, hi = block_range(vocab_size, m, j)
        shift = model_max(logits.amax(dim=-1))
        logz = shift + torch.log(model_sum(
            torch.exp(logits - shift[..., None]).sum(dim=-1)))
        labels = labels.long()
        here = (labels >= lo) & (labels < hi)
        local = torch.gather(logits, -1, (labels - lo).clamp(0, hi - lo - 1)
                             [..., None])[..., 0]
        gold = model_sum(torch.where(here, local, torch.zeros_like(local)))
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return batch_sum(nll.sum()) / torch.clamp(batch_sum(mask.sum()),
                                              min=1.0)


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
    """One cache per layer (``_init_block_cache``): a KV cache of
    ``max_seq`` rows for an attention layer, the (c_kv, k_rope) latents of
    ``max_seq`` rows for MLA, and the constant-size conv buffers and state
    for Mamba and (S, z) for NFFT."""
    dev = resolve_device(device)
    make = {"attn": lambda: init_kv_cache(cfg, batch, max_seq, device=dev),
            "mla": lambda: init_mla_cache(cfg, batch, max_seq, device=dev),
            "mamba": lambda: init_mamba_cache(cfg, batch, device=dev),
            "nfft": lambda: init_nfft_cache(cfg, batch, device=dev)}
    return [make[layer_signature(cfg, i).mixer]()
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
    ``len(prefix) + p * len(period) + slot``; ``mtp[t]`` becomes
    ``mtp[t]``.  Every leaf keeps its dtype (the MoE router and the SSM's
    ``a_log``, ``dt_bias`` and ``d_skip`` are float32 in a bf16 model).
    """
    dev = resolve_device(device)
    plan = make_layer_plan(cfg)
    with torch.device("meta"):
        model = Model(cfg, generator=None, device="meta")
    model = model.to_empty(device=dev)
    state = {name: tree[name] for name in
             ("embed", "frontend_proj", "final_norm", "lm_head")
             if name in tree}
    for i, block in enumerate(tree.get("prefix", [])):
        for name, leaf in _flatten(block):
            state[f"blocks.{i}.{name}"] = leaf
    for t, mtp in enumerate(tree.get("mtp", [])):
        for name, leaf in _flatten(mtp):
            state[f"mtp.{t}.{name}"] = leaf
    for slot, stacked in enumerate(tree.get("stack", [])):
        for name, leaf in _flatten(stacked):
            leaf = np.asarray(leaf)
            for p in range(plan.n_periods):
                layer = len(plan.prefix) + p * len(plan.period) + slot
                state[f"blocks.{layer}.{name}"] = leaf[p]
    model.load_state_dict({k: _tensor(v) for k, v in state.items()},
                          strict=True)
    return model
