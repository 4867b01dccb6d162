"""Mixture-of-Experts: shared + routed experts, capacity-based dispatch.

Counterpart of ``repro.models.moe``.  Dispatch is the reference's
position-in-expert scheme:
each (token, pick) in arrival order takes the next free slot of its
expert's (E, C) index matrix, and picks past the capacity C are dropped.
The router runs in f32.  The expert FFN is the reference's three einsums,
done as ``torch.bmm`` over (E, C, d) buffers (the reference computes them
outside any Pallas kernel, so they stay library matmuls).

Two points where the port departs from the reference's code on purpose:

* ``dispatch_indices`` takes each pick's slot from a stable sort by
  expert, writes the kept picks' arrival indices into the index matrix
  with a plain scatter, sends every dropped pick to one overflow element
  past the matrix, and leaves the empty slots at T·K: the matrix the
  reference meant, as its ``jnp.where(index_mat < 0, T * K, …)`` shows.
  The reference fills the matrix with the sentinel T·K and scatters with a
  maximum, so the sentinel wins every slot, its routed experts receive
  only zeros and add nothing (ROADMAP.md, Queue 3).  Its ``keep`` and
  ``slot`` are right and the port's equal them.
* The top-k picks ties by the lower expert index first, as
  ``jax.lax.top_k`` does (``torch.topk`` on CUDA does not promise an
  order): a stable descending sort.  The order of a token's K picks is
  the arrival order, which decides which picks the capacity drops.

Gradients (training) run through autograd, as ``jax.grad`` runs through
the reference: through the gather ``xt_pad[token_of]`` (its backward adds
each slot's gradient into its token's row, the discarded row T taking
the empty slots'), the three ``bmm``s, the combine (an empty slot's
write lands in the discarded row T·K, so its gradient is that row's, 0)
and the gate values, which the sort's gather hands to the router logits.
The expert ids, slots and ``keep`` are integers or masks and take none,
as in ``jax.lax.top_k``; a dropped pick's gate is multiplied by 0, so no
gradient reaches it.  The router learns through the gates alone: the
reference's ``loss_fn`` adds no ``load_balance_loss``, and neither does
the port's.

Over the workers of a mesh (``distributed.sharded_lm`` builds the
``MoESplit``), each worker routes its own tokens over all E experts (the
router is replicated) and runs the experts its parameters hold, in one of
two forms (``moe_ffn_workers``):

* Without ``moe_sharded``: the reference's sharded step, GSPMD's form of
  the unsharded ``moe_ffn`` over the *global* batch: the capacity is
  taken from the global token count, and each worker's slots are offset
  by the picks of every expert in the batch slices before its own
  (``MoESplit.exchange``), so ``keep`` and ``slot`` are the unsharded
  ones, bit for bit.
* With ``moe_sharded``: the reference's expert-parallel island
  (``moe_ffn_sharded``, ``moe.py:105-203``): tokens
  split over the data axes, experts and the shared MLP's hidden dimension
  over ``model``, the capacity and the slots a data shard's own, and one
  psum over ``model`` (``MoESplit.reduce``).  Its dispatch is the
  reference's with the fill it meant, as ``dispatch_indices`` is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, activation, dense_param, mlp, promote


class MoE(nn.Module):
    """Router (d, E), experts ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d),
    and, with ``num_shared_experts``, a gated ``shared`` MLP at
    ``moe_d_ff · num_shared_experts``, drawn in the reference's order."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = dense_param((d, E), generator, device,
                                  ("embed", None), scale=0.02)
        self.wi = dense_param((E, d, f), generator, device,
                              ("experts", "embed", "mlp"))
        self.wg = dense_param((E, d, f), generator, device,
                              ("experts", "embed", "mlp"))
        self.wo = dense_param((E, f, d), generator, device,
                              ("experts", "mlp", "embed"))
        if cfg.num_shared_experts:
            self.shared = MLP(d, f * cfg.num_shared_experts, True,
                              generator, device)


def init_moe(cfg, generator: torch.Generator, device=None) -> MoE:
    return MoE(cfg, generator, device)


def capacity(cfg, tokens: int) -> int:
    """Slots an expert has for ``tokens`` tokens: the reference's
    ``int(T * K / E * capacity_factor) + 1``, in Python floats."""
    return int(tokens * cfg.top_k / cfg.num_experts
               * cfg.capacity_factor) + 1


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    ties by the lower index first."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


class _WideMatmul(torch.autograd.Function):
    """``x.float() @ w.float()`` for 2-D ``x`` and ``w``, saving ``x`` and
    ``w`` as they were passed rather than their f32 copies: a bf16 operand
    is kept at half the bytes, and a saved-tensor hook sees the caller's
    tensor.  Its gradients are the widened product's, each cast back to
    its operand's dtype, as the two ``.float()`` casts would."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.float().T @ g).to(w.dtype)
        return gx, gw


def route(params: MoE, cfg, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) → (router logits (T, E) f32, gate values (T, K) f32,
    expert ids (T, K) int64), the reference's router."""
    logits = _WideMatmul.apply(xt, params.router)
    scores = (torch.softmax(logits, dim=-1) if cfg.router_softmax_then_topk
              else logits)
    _, expert_ids = top_k(scores, cfg.top_k)
    return logits, gates(cfg, logits, expert_ids), expert_ids


def gates(cfg, logits: torch.Tensor, expert_ids: torch.Tensor
          ) -> torch.Tensor:
    """The gate values (T, K) of picks ``expert_ids`` from the router
    logits (T, E), as the reference forms them: the softmax over all
    experts at the picks (``router_softmax_then_topk``) or the softmax
    over the picks' logits, then (``norm_topk_prob``) over their sum."""
    if cfg.router_softmax_then_topk:
        vals = torch.softmax(logits, dim=-1).gather(-1, expert_ids)
    else:
        vals = torch.softmax(logits.gather(-1, expert_ids), dim=-1)
    if cfg.norm_topk_prob:
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals


def dispatch_indices(expert_ids: torch.Tensor, num_experts: int,
                     capacity: int, offsets: torch.Tensor | None = None,
                     experts: tuple[int, int] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expert_ids (T, K) → (index_mat (E, C) int64 into T·K, T·K where
    the slot is empty; keep (T, K) bool; slot (T, K) int64).

    A pick's slot is its occurrence rank among the picks of its expert in
    arrival order (token-major, then pick order): the reference's cumsum
    of a (T·K, E) one-hot, here its position in a stable sort by expert
    less the start of its expert's run (the same integers, without the
    one-hot; the cumsum down its long axis took 12.9 ms a layer at
    DeepSeek-V2-Lite's prefill on the H100).  It is kept if its slot is
    below ``capacity``.  The kept (expert, slot) pairs are unique, so each
    index is written once; the dropped picks all go to one extra element
    past the matrix, written in no fixed order and discarded.  No host
    synchronization.

    On a mesh, ``offsets`` (E,) counts each expert's picks that arrive
    before these tokens (the earlier batch slices), and the slots are the
    global ones; ``experts`` = (lo, n) makes the index matrix (n, C) of
    experts lo … lo + n − 1 only, a worker's.  ``keep`` and ``slot`` cover
    every pick either way."""
    T, K = expert_ids.shape
    E, C = num_experts, capacity
    lo, n = experts if experts is not None else (0, E)
    flat = expert_ids.reshape(-1).long()                    # arrival order
    by_expert, order = torch.sort(flat, stable=True)
    run_start = torch.searchsorted(by_expert, by_expert)
    slot = torch.empty_like(flat)
    slot[order] = torch.arange(T * K, device=flat.device) - run_start
    if offsets is not None:
        slot = slot + offsets[flat]
    keep = slot < C
    local, write = flat, keep
    if (lo, n) != (0, E):
        local = flat - lo
        write = keep & (local >= 0) & (local < n)
    where = torch.where(write, local * C + slot, n * C)
    index_mat = torch.full((n * C + 1,), T * K, dtype=torch.long,
                           device=flat.device)
    index_mat.scatter_(0, where, torch.arange(T * K, device=flat.device))
    return (index_mat[:n * C].reshape(n, C), keep.reshape(T, K),
            slot.reshape(T, K))


def moe_ffn(params: MoE, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) → (B, S, d), in the promoted dtype of x and the
    weights (f32 for f32 weights, as the reference's einsums give)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    _, gate_vals, expert_ids = route(params, cfg, xt)
    index_mat, keep, _ = dispatch_indices(expert_ids, cfg.num_experts,
                                          capacity(cfg, T))
    return _experts(params, cfg, xt, gate_vals, index_mat, keep).reshape(
        B, S, d)


def _experts(params, cfg, xt: torch.Tensor, gate_vals: torch.Tensor,
             index_mat: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The routed experts of ``index_mat``'s rows, and the shared MLP
    where ``params`` has one: xt (T, d) → (T, d)."""
    y = _routed(params, cfg, xt, gate_vals, index_mat, keep)
    if hasattr(params, "shared"):
        y = y + mlp(params.shared, xt, cfg.activation)
    return y


def _routed(params, cfg, xt: torch.Tensor, gate_vals: torch.Tensor,
            index_mat: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    T, d = xt.shape
    K = cfg.top_k
    # gather tokens into expert buffers (E, C, d); empty slots read zeros
    token_of = torch.where(index_mat >= T * K, T,
                           torch.div(index_mat, K, rounding_mode="floor"))
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    expert_in, wi = promote(xt_pad[token_of], params.wi)
    h = torch.bmm(expert_in, wi)
    g = torch.bmm(expert_in, params.wg.to(wi.dtype))
    del expert_in
    h = activation(cfg.activation, g) * h
    del g
    expert_out = torch.bmm(h, params.wo.to(h.dtype))        # (E, C, d)
    del h

    # combine: scatter the expert outputs back to (token, pick) rows.  The
    # kept indices are unique; every empty slot writes row T·K, in no fixed
    # order (index_put_ with duplicates), and that row is discarded; the
    # rows of picks another worker's experts take stay 0
    flat_out = expert_out.new_zeros((T * K + 1, d))
    flat_out[index_mat.reshape(-1)] = expert_out.reshape(-1, d)
    del expert_out
    gates = (gate_vals * keep).to(flat_out.dtype)           # dropped → 0
    return torch.einsum("tkd,tk->td", flat_out[:T * K].reshape(T, K, d),
                        gates)


@dataclasses.dataclass(frozen=True)
class MoESplit:
    """How one MoE layer runs over a mesh's M workers.

    ``experts[m]``  (lo, n): the experts worker m's ``wi``/``wg``/``wo``
                    hold (n may be 0: a worker that adds no routed part)
    ``tokens``      the token count the capacity is taken from (the global
                    batch's), or None: each worker's own (after ``gather``)
    ``exchange``    the workers' per-expert pick counts (E,) int32 → each
                    one's count of picks in the batch slices before its
                    own; or None (every worker's slots its own)
    ``gather``      the workers' inputs → the inputs the experts run on
                    (the island's rows of a data shard), or None
    ``reduce``      the workers' outputs → the layer's (the island's psum
                    over ``model``), or None
    """

    experts: Sequence[tuple[int, int]]
    tokens: int | None = None
    exchange: Callable[[list], list] | None = None
    gather: Callable[[list], list] | None = None
    reduce: Callable[[list], list] | None = None


def moe_ffn_workers(params: list, cfg, xs: list, split: MoESplit) -> list:
    """The MoE layer over a mesh's workers, one entry of ``params`` and
    ``xs`` a worker, in the form ``split`` gives: GSPMD's form of
    ``moe_ffn`` over the global batch (the reference's sharded step), or
    the expert-parallel island (its ``moe_ffn_sharded``, under
    ``cfg.moe_sharded``).  Worker m's output is its experts'
    (``split.experts[m]``) and, where it holds one, its shared MLP's, then
    ``split.reduce``'s."""
    xs = split.gather(xs) if split.gather is not None else xs
    xts = [x.reshape(-1, x.shape[-1]) for x in xs]
    routes = [route(p, cfg, xt) for p, xt in zip(params, xts)]
    offsets = (split.exchange([torch.bincount(
        ids.reshape(-1), minlength=cfg.num_experts).int()
        for _, _, ids in routes])
               if split.exchange is not None else [None] * len(xs))
    ys = []
    for p, x, xt, (_, gate_vals, ids), off, ex in zip(
            params, xs, xts, routes, offsets, split.experts):
        C = capacity(cfg, split.tokens or xt.shape[0])
        index_mat, keep, _ = dispatch_indices(ids, cfg.num_experts, C, off,
                                              ex)
        ys.append(_experts(p, cfg, xt, gate_vals, index_mat, keep)
                  .reshape(x.shape))
    return split.reduce(ys) if split.reduce is not None else ys


def load_balance_loss(logits: torch.Tensor, expert_ids: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Aux loss (Switch): E · Σ_e f_e · p_e over the first picks (not used
    by the default configs)."""
    probs = torch.softmax(logits, dim=-1)
    f = F.one_hot(expert_ids[..., 0].long(), E).to(probs.dtype).mean(0)
    return E * torch.sum(f * probs.mean(0))
