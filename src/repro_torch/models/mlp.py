"""Feed-forward layers: the gated MLPs (SwiGLU/GeGLU), the plain GELU MLP,
and the capacity-routed mixture of experts.

The port of ``repro.models.mlp``.  The JAX package computes every product
here with ``jnp`` einsums outside any Pallas kernel, so the port does too:
the experts' products are batched matrix products over the expert axis.
Without a mesh, MoE routing uses the config's ``token_groups``; under one
(:func:`repro_torch.models.common.set_mesh`) the group count is the mesh's
pod x data extent, halved until it divides the batch's tokens, as the
reference's, and a rank that holds a block of the batch routes its own
whole groups (see :meth:`MoE.route`).  Under a model split (the sharded
train and serving steps) the MLP computes this rank's block of hidden
units and the MoE its block of experts (whole when the split does not
divide them), each summing its partial output over the split.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    activation_fn, batch_block, batch_sum, current_mesh, dense_init,
    model_copy, model_split, model_sum, part_split,
)


class MLP(nn.Module):
    """``init_mlp``: w_up (d, ff), w_down (ff, d), and w_gate (d, ff) when
    the activation is gated."""

    def __init__(self, d_model: int, d_ff: int, activation: str, dtype, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.activation = activation
        kw = dict(generator=generator, device=device)
        self.w_up = dense_init((d_model, d_ff), dtype, **kw)
        self.w_down = dense_init((d_ff, d_model), dtype, **kw)
        if activation in ("silu", "geglu"):
            self.w_gate = dense_init((d_model, d_ff), dtype, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``mlp_forward``; under a model split, this rank's hidden units'
        part, summed over the split."""
        if model_split()[1] > 1:
            return model_sum(self.partial(model_copy(x)))
        return self.partial(x)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The output of the hidden units whose weights are in hand: the
        whole MLP, or a rank's block of it under a model split."""
        act = activation_fn(self.activation)
        up = x @ self.w_up
        if self.activation in ("silu", "geglu"):
            h = act(x @ self.w_gate) * up
        else:
            h = act(up)
        return h @ self.w_down


class Routing(NamedTuple):
    """One MoE call's routing of t tokens into ``groups`` groups of tg."""
    top_p: torch.Tensor  # (t, k) gates, renormalised over the k choices
    top_idx: torch.Tensor  # (t, k) experts, in descending probability
    aux: torch.Tensor  # the Switch load-balancing loss, float32
    capacity: int  # choices an expert takes per group
    pos: torch.Tensor  # (groups, tg·k) each choice's place in its queue
    within: torch.Tensor  # (groups, tg·k) pos < capacity: the choice kept
    slot: torch.Tensor  # (groups, tg·k) its buffer row; the sink if dropped


def moe_groups(t: int, token_groups: int) -> int:
    """The routing's token groups: ``token_groups`` halved until it divides
    the t tokens."""
    groups = token_groups
    while t % groups != 0:
        groups //= 2
    return groups


class MoE(nn.Module):
    """``init_moe``: a float32 router (d, e), experts w_up and w_gate
    (e, d, f) and w_down (e, f, d), and an MLP ``shared`` of
    ``num_shared_experts * f`` hidden units when there is one.  (Each
    expert matrix is drawn as ``dense_init`` draws it: with the fan-in of
    its first axis, as the JAX package does.)"""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        self.cfg = cfg
        moe = cfg.moe
        d, e, f = cfg.d_model, moe.num_experts, moe.d_ff_expert
        kw = dict(generator=generator, device=device)
        self.router = dense_init((d, e), torch.float32, **kw)
        self.w_up = dense_init((e, d, f), cfg.pdtype, **kw)
        self.w_down = dense_init((e, f, d), cfg.pdtype, **kw)
        if cfg.activation in ("silu", "geglu"):
            self.w_gate = dense_init((e, d, f), cfg.pdtype, **kw)
        if moe.num_shared_experts > 0:
            self.shared = MLP(d, moe.num_shared_experts * f, cfg.activation,
                              cfg.pdtype, **kw)

    def route(self, xt: torch.Tensor) -> Routing:
        """The routing of t tokens xt (t, d).

        The router runs in float32.  Per group of tg tokens, each expert
        takes ``max(1, int(capacity_factor · tg · k / e))`` choices, in
        token-major (token, choice) order: the exclusive cumulative count
        of the expert's earlier choices in the group is the choice's
        place; a place at or past the capacity drops the choice.  A kept
        choice's slot is ``expert · capacity + place``; a dropped one's is
        the sink, ``e · capacity``.

        Under a mesh the groups are ``moe_groups`` of the whole batch's
        tokens with the mesh's pod x data extent, and the aux loss's means
        run over the whole batch (:func:`batch_sum` of the sums).  Each
        rank's rows are whole groups of the batch (contiguous tokens), so
        it routes them alone; a group that would span two ranks' rows
        raises."""
        moe = self.cfg.moe
        e, k = moe.num_experts, moe.top_k
        t = xt.shape[0]
        logits = xt.float() @ self.router
        probs = torch.softmax(logits, dim=-1)
        top_p, top_idx = torch.topk(probs, k, dim=-1, sorted=True)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        mesh = current_mesh()
        if mesh is None:
            me = probs.mean(dim=0)
            ce = F.one_hot(top_idx, e).sum(1).float().mean(dim=0) / k
            groups = moe_groups(t, moe.token_groups)
            tg = t // groups
        else:
            t_all = t * batch_block()[1]
            me = batch_sum(probs.sum(dim=0)) / t_all
            ce = batch_sum(F.one_hot(top_idx, e).sum(1).float().sum(dim=0)
                           ) / t_all / k
            fsdp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
            tg = t_all // moe_groups(t_all, fsdp)
            if t % tg:
                raise ValueError(
                    f"MoE routing: a group of {tg} tokens spans this rank's "
                    f"{t} tokens and another rank's (batch of {t_all} "
                    f"tokens on mesh {mesh.shape}); route with a batch "
                    "whose rows split into whole groups")
            groups = t // tg
        aux = e * (me * ce).sum()
        capacity = max(1, int(moe.capacity_factor * tg * k / e))
        flat = top_idx.reshape(groups, tg * k)
        one_hot = F.one_hot(flat, e)  # (g, tg·k, e)
        before = one_hot.cumsum(dim=1) - one_hot  # exclusive, per group
        pos = torch.gather(before, 2, flat[..., None])[..., 0]
        within = pos < capacity
        slot = torch.where(within, flat * capacity + pos,
                           torch.full_like(flat, e * capacity))
        return Routing(top_p, top_idx, aux, capacity, pos, within, slot)

    def forward(self, x: torch.Tensor):
        """``moe_forward``: x (b, s, d) -> (output (b, s, d) in x's dtype,
        the float32 aux loss).

        Each kept choice's token row goes to slot ``expert · capacity +
        place`` of its group's (e · capacity + 1, d) buffer; the last row
        is a sink that every dropped choice writes to and that no expert
        reads (an indexed write to one row from many sources is undefined,
        and only the sink takes more than one).  The experts' products are
        batched over the expert axis; each choice reads its slot back (a
        dropped one a zero row) and is weighted by its gate, zero when
        dropped.  Both indexings carry gradients.

        Under a model split of M, every rank routes the same rows alike
        (the routing, its aux loss and the slots are replicated), runs its
        ceil block of the experts (``w_up``, ``w_gate``, ``w_down`` hold
        theirs; none on a rank past the last block) on their slots, combines the choices that landed on them (a choice
        elsewhere reads the sink's zero row) and adds its block of the
        shared expert; the partial outputs are summed over the split: one
        all-reduce of (t, d), 2 (M - 1) / M t d elements on a ring, where
        all-gathering the experts' outputs, as the reference's constraints
        do, sends (M - 1) / M capacity_factor top_k t d.  The tokens and
        the gates enter through :func:`model_copy`: each rank's gradient of
        them is a part."""
        moe = self.cfg.moe
        b, s, d = x.shape
        t = b * s
        xt = x.reshape(t, d)
        r = self.route(xt)
        lo, hi, m = part_split(self.cfg, "moe")
        if m == 1:
            out = self._dispatch(xt, r.slot, r.top_p, r, moe.num_experts)
            if moe.num_shared_experts > 0:
                out = out + self.shared(xt)
            return out.reshape(b, s, d).to(x.dtype), r.aux.float()
        flat = r.top_idx.reshape(r.slot.shape)
        mine = r.within & (flat >= lo) & (flat < hi)
        slot = torch.where(mine, r.slot - lo * r.capacity,
                           torch.full_like(r.slot, (hi - lo) * r.capacity))
        xin = model_copy(xt)
        out = self._dispatch(xin, slot, model_copy(r.top_p), r, hi - lo)
        if moe.num_shared_experts > 0:
            out = out + self.shared.partial(xin)
        return model_sum(out).reshape(b, s, d).to(x.dtype), r.aux.float()

    def _dispatch(self, xt, slot, top_p, r: Routing, experts: int):
        """The (t, d) output of the ``experts`` experts in hand: each
        choice's token row to its ``slot`` of its group's buffer (the
        sink, ``experts · capacity``, for a choice they do not take), the
        experts' products, each choice's slot back, weighted by its gate
        (zero when dropped) and summed over the k choices."""
        k = self.cfg.moe.top_k
        t, d = xt.shape
        groups, tg = slot.shape[0], t // slot.shape[0]
        capacity, sink = r.capacity, experts * r.capacity
        gi = torch.arange(groups, device=xt.device)[:, None]
        src = xt.reshape(groups, tg, d).repeat_interleave(k, dim=1)
        buf = xt.new_zeros((groups, sink + 1, d)).index_put((gi, slot), src)
        expert_in = (buf[:, :sink].reshape(groups, experts, capacity, d)
                     .transpose(0, 1).reshape(experts, groups * capacity, d))
        act = self.cfg.activation
        up = torch.bmm(expert_in, self.w_up)
        if act in ("silu", "geglu"):
            h = activation_fn(act)(torch.bmm(expert_in, self.w_gate)) * up
        else:
            h = activation_fn("gelu")(up)
        expert_out = torch.bmm(h, self.w_down)
        back = (expert_out.reshape(experts, groups, capacity, d)
                .transpose(0, 1).reshape(groups, sink, d))
        back = torch.cat([back, back.new_zeros((groups, 1, d))], dim=1)
        rows = back[gi, slot].reshape(groups, tg, k, d)
        gate_w = (top_p.reshape(groups, tg, k)
                  * r.within.reshape(groups, tg, k)).to(rows.dtype)
        return torch.einsum("gtkd,gtk->gtd", rows, gate_w).reshape(t, d)
