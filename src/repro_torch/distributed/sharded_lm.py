"""The LM's loss with its parameters sharded over an in-process mesh.

The reference jits its training step with ``in_shardings`` from
``distributed.sharding`` and lets GSPMD place the collectives.  Here the
workers of a ``launch.mesh.Mesh`` (``(data, model)``, data-major) run as
one autograd graph, each worker's tensors on its own device, and the
collectives are explicit (``collectives.GatherLeaf``, ``Psum``):

* Before a layer runs, every leaf of that layer is all-gathered over the
  mesh axes its spec binds — except a dimension on ``model`` whose logical
  axis is a tensor-parallel one (``TP_AXES``: ``heads``, ``kv_heads``,
  ``mlp``, ``vocab``, ``experts``) while the batch is shared over
  ``model``.  That dimension stays the worker's own slice.  Any other axis
  on ``model`` (``fsdp_tp_v2``'s ``kv_lora``) is gathered.
* A worker then runs the port's attention on its H/mp query heads (and the
  KV heads their groups read; MLA: its heads of ``wq``, ``w_uk``, ``w_uv``
  and ``wo``, with the latent ``w_dkv``, ``kv_norm`` and ``w_kpe``
  replicated), its Tucker or dense FFN on its d_ff/mp rows, and its E/mp
  experts, through the unsharded model's layer body
  (``blocks.apply_layer_workers``) and its kernels; the outputs after
  ``wo`` and after the FFN are partial sums, ``Psum``'d over ``model`` by
  the body's reduce hook.  An MoE FFN's output is one uniform partial sum:
  where its experts are split and its shared MLP is not (zero3), the
  shared MLP's output is added by the first worker of each ``model``
  group alone.
* The MoE routes over the global batch as the reference's GSPMD step
  does (``moe.moe_ffn_workers``): the capacity from the global token
  count, and each worker's slots offset by the per-expert counts of the
  batch slices before its own (``collectives.prefix_counts``), so
  ``keep`` and ``slot`` are the unsharded ones.  With ``cfg.moe_sharded``
  it is the reference's expert-parallel island instead: experts and the
  shared MLP's hidden dimension over ``model`` whatever the policy (a
  worker narrows a leaf the layout did not slice), the capacity and slots
  of each data shard, the rows of a data shard gathered over ``model``
  first where the batch is split over it (zero3_dp), and one ``Psum`` over
  ``model``.
* The embedding and the head are vocab-parallel: a worker looks up the
  tokens in its vocab rows (``Psum`` over ``model``) and computes logits
  (B_w, S, V/mp); the cross-entropy takes the max, the sum of exponentials
  and the gold logit through fixed-order reductions over ``model``.
* The batch is split by ``sharding.batch_spec``.  The loss is the sum of
  the negative log-likelihoods over the global batch's tokens divided by
  their count, each token counted once: from the first worker holding its
  batch slice (``Layout.owners``), so a batch replicated because it does
  not divide is not counted M times.

Every shard feeds exactly one op, its ``GatherLeaf``, whose backward sums
the workers' gradients in worker order; a leaf replicated over an axis is
one parameter, and each of its copies receives the same sum.  Under
``mixed_precision`` (bf16) a worker's f32 part is cast to bf16 before its
``GatherLeaf``, as the reference's ``_cast_params`` sits on the sharded
leaf: the all-gathers move bf16, and the sums over workers of the
gradients are added in f32, the parts' dtype.  On a mesh of one worker no
collective runs and the ops are the unsharded model's, in its order, so
the step is ``make_train_step``'s bit for bit (the island aside, which is
``moe_ffn`` within rounding there).

The gathered copies of the matrices (and their bf16 casts), and the
head's copy cast to the activation dtype, are not kept for the backward:
the ops that save them save a handle instead (``saved_tensors_hooks``),
and the backward gathers the copy again — one more all-gather of it a
step, as FSDP does — so the peak holds the shards and about one layer's
gathered copies a worker.
"""
from __future__ import annotations

import types
import weakref
from typing import Callable, Mapping

import torch

from repro_torch.configs import require_ported
from repro_torch.distributed import collectives, context as dist_ctx
from repro_torch.distributed.sharding import (BATCH_AXES_BY_POLICY, Layout,
                                              ShardedTensor, batch_spec,
                                              entry_axes)
from repro_torch.models.blocks import apply_layer_workers, layer_specs
from repro_torch.models.layers import embed, make_norm
from repro_torch.models.model import (activation_dtype, init_model,
                                      nll_terms, param_axes)
from repro_torch.models.moe import MoESplit

# the logical axes whose dimension on ``model`` a worker keeps as its slice
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts")


def _nest(flat: Mapping[str, torch.Tensor]) -> types.SimpleNamespace:
    """{"mixer.wq": t, ...} → a namespace with ``.mixer.wq``."""
    root: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t

    def ns(d):
        return types.SimpleNamespace(**{k: ns(v) if isinstance(v, dict)
                                        else v for k, v in d.items()})

    return ns(root)


def model_groups(mesh) -> list[list[int]]:
    """The workers of each ``model``-axis group (equal coordinates on every
    other axis), in worker order."""
    probe = Layout((1,), (), mesh)
    groups: dict[tuple, list[int]] = {}
    for m in range(mesh.size):
        c = probe.coords(m)
        groups.setdefault(tuple(v for a, v in c.items() if a != "model"),
                          []).append(m)
    return list(groups.values())


class _Rebuilt:
    """Saved-tensor hooks: a tensor registered with a function that makes
    it again is saved as that function (and the view's geometry) and made
    again when the backward unpacks it."""

    def __init__(self):
        self._live: dict[int, Callable[[], torch.Tensor]] = {}

    def register(self, t: torch.Tensor, make: Callable[[], torch.Tensor]
                 ) -> None:
        key = t.untyped_storage().data_ptr()
        self._live[key] = make
        weakref.finalize(t, self._live.pop, key, None)

    def pack(self, t: torch.Tensor):
        make = self._live.get(t.untyped_storage().data_ptr())
        if make is None:
            # not ``t`` itself: an op that saves its own output would hold
            # it, and so its own node, in a cycle the garbage collector
            # cannot see, which leaks the whole graph above an op the
            # backward never runs (the softmax that only ranks the router's
            # picks)
            return t.detach()
        return make, t.size(), t.stride(), t.storage_offset()

    @staticmethod
    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        make, size, stride, offset = saved
        return make().as_strided(size, stride, offset)


def require_tokens(cfg) -> None:
    """Raise for a config with a frontend: the sharded loss embeds tokens
    (``ShardedLM._embed``); sharding the frames' or patches' projection
    is not ported yet (ROADMAP.md, Queue 1)."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: sharded training of a config with the "
            f"{cfg.frontend} frontend is not ported to repro_torch yet; it "
            "trains on one device (make_train_step; see ROADMAP.md, "
            "Queue 1)")


class ShardedLM:
    """The loss of ``cfg``'s model over ``mesh``, its parameters on
    ``layouts`` ({name: Layout}) under ``policy``.  Configs with a
    frontend are refused (``require_tokens``)."""

    def __init__(self, cfg, mesh, layouts: Mapping[str, Layout],
                 policy: str, backend: str | None = None,
                 traffic: collectives.Traffic | None = None):
        require_ported(cfg)
        require_tokens(cfg)
        self.cfg, self.mesh, self.policy = cfg, mesh, policy
        self.layouts = dict(layouts)
        self.backend = backend
        self.traffic = traffic
        self.specs = layer_specs(cfg)
        self.axes = param_axes(init_model(cfg, device="meta"))
        self.cast = (torch.bfloat16 if cfg.mixed_precision
                     and cfg.dtype == "bfloat16" else None)
        batch_axes = BATCH_AXES_BY_POLICY.get(policy, ("pod", "data"))
        self.tensor_parallel = "model" not in batch_axes
        self.groups = model_groups(mesh)
        probe = Layout((1,), (), mesh)
        self.model_coord = [probe.coords(m).get("model", 0)
                            for m in range(mesh.size)]
        self.plans = {n: collectives.GatherPlan(lay, self.kept(n))
                      for n, lay in self.layouts.items()}
        self.moe = {i: self._moe_plan(i) for i, spec in enumerate(self.specs)
                    if spec.endswith("+moe")}
        self._rebuilt = _Rebuilt()

    def kept(self, name: str) -> tuple[int, ...]:
        """The dimensions of leaf ``name`` a worker keeps as its own
        ``model`` slice: those on ``model`` whose logical axis is in
        ``TP_AXES``, while the batch is shared over ``model``."""
        if not self.tensor_parallel:
            return ()
        return tuple(d for d, (e, ax) in enumerate(zip(
            self.layouts[name].spec, self.axes[name]))
            if "model" in entry_axes(e) and ax in TP_AXES)

    def _slice(self, name: str, dim: int, m: int) -> slice | None:
        """Worker m's slice of ``dim`` of leaf ``name`` where it is kept,
        else None."""
        if dim not in self.kept(name):
            return None
        s = self.plans[name].region[m][dim]
        return None if (s.start, s.stop) == (0, self.layouts[name].shape[
            dim]) else s

    def _gather_leaf(self, params, name: str) -> list[torch.Tensor]:
        """``GatherLeaf`` of one leaf; a matrix's gathered copies are made
        again in the backward rather than kept."""
        parts = params[name].parts
        out = collectives.gather_leaf(self.plans[name], parts, self.traffic,
                                      self.cast)
        if parts[0].dim() >= 2 and name != "embed.embedding":
            for m, t in enumerate(out):
                if len(out) > 1 and (self.cast is not None
                                     or not self.plans[name].own[m]):
                    self._rebuilt.register(
                        t, lambda m=m: self._region(name, m, parts))
        return out

    def _region(self, name: str, m: int, parts) -> torch.Tensor:
        """Worker m's region of leaf ``name`` again (in the gathered
        dtype), without autograd (its own part where it is that)."""
        plan = self.plans[name]
        if plan.own[m] or len(parts) == 1:
            own = parts[m].detach()
            return own if self.cast is None else own.to(self.cast)
        with torch.no_grad():
            buf = plan.gather_one(parts, m, self.cast)
        if self.traffic is not None and m == 0:     # a figure a worker
            self.traffic.add_all_gather(collectives.nbytes(buf), plan.group)
        return buf

    def gather(self, params: Mapping[str, ShardedTensor], prefix: str
               ) -> list[types.SimpleNamespace]:
        """Every leaf under ``prefix`` gathered → one namespace a worker."""
        names = [n for n in self.layouts if n.startswith(prefix)]
        per = {n[len(prefix):]: self._gather_leaf(params, n) for n in names}
        return [_nest({k: v[m] for k, v in per.items()})
                for m in range(self.mesh.size)]

    def psum(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        return collectives.psum_groups(parts, self.groups, self.traffic)

    # -- the model, worker by worker ------------------------------------------

    def _local_attention(self, mixer, i: int, m: int):
        """The worker's attention weights: its query heads and the KV heads
        their groups read (``mixer`` itself where it holds every head)."""
        cfg = self.cfg
        hs = self._slice(f"layers.{i}.mixer.wq", 1, m)
        if hs is None:
            return mixer
        lo, n = hs.start, hs.stop - hs.start
        if hasattr(mixer, "w_uk"):
            # MLA: every head has its own up-projections; the latent's
            # leaves are gathered whole and replicated
            mixer = types.SimpleNamespace(**vars(mixer))
            for w, dim in (("w_uk", 1), ("w_uv", 1), ("wo", 0)):
                if self._slice(f"layers.{i}.mixer.{w}", dim, m) is None:
                    setattr(mixer, w, getattr(mixer, w).narrow(dim, lo, n))
            return mixer
        G = cfg.num_heads // cfg.num_kv_heads
        if self._slice(f"layers.{i}.mixer.wk", 1, m) is None:
            # the KV heads replicated (they do not divide the axis)
            if n % G == 0 and lo % G == 0:
                sel = lambda w: w.narrow(1, lo // G, n // G)   # noqa: E731
            elif G % n == 0:
                sel = lambda w: w.narrow(1, lo // G, 1)        # noqa: E731
            else:
                idx = torch.tensor([h // G for h in range(lo, lo + n)],
                                   device=mixer.wk.device)
                sel = lambda w: w.index_select(1, idx)         # noqa: E731
            mixer = types.SimpleNamespace(**vars(mixer))
            mixer.wk, mixer.wv = sel(mixer.wk), sel(mixer.wv)
            if hasattr(mixer, "bk"):
                mixer.bk = sel(mixer.bk.unsqueeze(0))[0]
                mixer.bv = sel(mixer.bv.unsqueeze(0))[0]
        return mixer

    def _embed(self, params, tokens: list[torch.Tensor]):
        name = "embed.embedding"
        E = collectives.gather_leaf(self.plans[name], params[name].parts,
                                    self.traffic, self.cast)
        dt = activation_dtype(self.cfg)
        rows = []
        vocab_parallel = False
        for m, (table, tok) in enumerate(zip(E, tokens)):
            s = self._slice(name, 0, m)
            if s is None:
                rows.append(embed(types.SimpleNamespace(embedding=table),
                                  tok))
                continue
            vocab_parallel = True
            local = tok - s.start
            mine = (local >= 0) & (local < s.stop - s.start)
            got = table[torch.where(mine, local, 0)]
            rows.append(torch.where(mine[..., None], got, 0.0))
        if vocab_parallel:
            rows = self.psum(rows)
        return [r.to(dt) for r in rows]

    def _nll(self, params, xs, labels):
        """Each worker's (summed nll, valid count) of its batch slice."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm_type)
        tied = "lm_head" not in self.layouts
        name = "embed.embedding" if tied else "lm_head"
        vdim = 0 if tied else 1
        H = (collectives.gather_leaf(self.plans[name], params[name].parts,
                                     self.traffic, self.cast) if tied
             else self._gather_leaf(params, name))
        lnf = self.gather(params, "ln_f.")
        logits, spans = [], []
        parts = params[name].parts
        for m, x in enumerate(xs):
            x = norm(lnf[m], x, cfg.norm_eps)
            head = H[m].T if tied else H[m]
            cast = head.to(x.dtype)
            if cast is not head:    # the activation-dtype copy of the head
                self._rebuilt.register(cast, lambda m=m, dt=x.dtype: (
                    self._region(name, m, parts).T if tied else
                    self._region(name, m, parts)).to(dt))
            logits.append(dist_ctx.constrain_logits(x @ cast))
            spans.append(self._slice(name, vdim, m))
        if spans[0] is None:
            out = []
            for lg, lab in zip(logits, labels):
                nll, valid = nll_terms(lg, lab)
                out.append((nll.sum(), valid.sum()))
            return out
        # vocab-parallel cross-entropy
        lfs = [lg.float() for lg in logits]
        gmax = collectives.pmax_groups([lf.detach().amax(-1) for lf in lfs],
                                       self.groups, self.traffic)
        shifted = [lf - mx[..., None] for lf, mx in zip(lfs, gmax)]
        sumexp = self.psum([s.exp().sum(-1) for s in shifted])
        golds = []
        for s, sp, lab in zip(shifted, spans, labels):
            local = lab.long() - sp.start
            mine = (local >= 0) & (local < sp.stop - sp.start)
            g = torch.gather(s, -1, torch.where(mine, local, 0)[..., None])
            golds.append(torch.where(mine, g[..., 0], 0.0))
        golds = self.psum(golds)
        out = []
        for se, g, lab in zip(sumexp, golds, labels):
            valid = lab != -100
            nll = (torch.log(se) - g) * valid
            out.append((nll.sum(), valid.sum()))
        return out

    def loss(self, params: Mapping[str, ShardedTensor],
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Mean cross-entropy over the global batch (``tokens``/``labels``
        (B, S) on any device), on worker 0's device."""
        cfg, mesh = self.cfg, self.mesh
        M = mesh.size
        B = batch["tokens"].shape[0]
        blay = Layout(tuple(batch["tokens"].shape),
                      batch_spec(mesh, B, 1, self.policy), mesh)
        tokens, labels = [], []
        for m, dev in enumerate(mesh.devices):
            rows = blay.index(m)[0]
            tokens.append(batch["tokens"][rows].to(dev))
            labels.append(batch["labels"][rows].to(dev))
        with torch.autograd.graph.saved_tensors_hooks(self._rebuilt.pack,
                                                      self._rebuilt.unpack):
            return self._loss(params, tokens, labels, blay)

    def _loss(self, params, tokens, labels, blay) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        xs = self._embed(params, tokens)
        pos = [torch.arange(x.shape[1], device=x.device) for x in xs]
        for i, spec in enumerate(self.specs):
            w = self.gather(params, f"layers.{i}.")
            local = [self._local_layer(w[m], i, m) for m in range(mesh.size)]
            xs, _ = apply_layer_workers(
                local, cfg, spec, xs, positions=pos, backend=self.backend,
                reduce=self._reducer(i),
                moe=self._moe_split(i, blay, xs[0].shape[1]))
            xs = [dist_ctx.constrain(x) for x in xs]
        terms = self._nll(params, xs, labels)
        dev0 = mesh.devices[0]
        total = count = None
        for m in blay.owners():
            s, c = (t.to(dev0) for t in terms[m])
            total = s if total is None else total + s
            count = c if count is None else count + c
        return total / torch.clamp(count, min=1)

    def _local_layer(self, w, i: int, m: int) -> types.SimpleNamespace:
        """Layer i's gathered weights on worker m, its attention cut to the
        worker's heads and an MoE FFN to its experts and shared slice."""
        mixer = self._local_attention(w.mixer, i, m)
        ffn = self._local_moe(w.ffn, i, m) if i in self.moe else w.ffn
        if mixer is w.mixer and ffn is w.ffn:
            return w
        return types.SimpleNamespace(**{**vars(w), "mixer": mixer,
                                        "ffn": ffn})

    def _reducer(self, i: int):
        """``apply_layer_workers``' reduce for layer i: the ``Psum`` over
        ``model`` of each sublayer whose output is a partial sum (the
        island sums its own)."""
        if i in self.moe:
            ffn_partial = self.moe[i].partial
        else:
            ffn = next(n for n in (f"layers.{i}.ffn.up.u2",
                                   f"layers.{i}.ffn.wi") if n in self.layouts)
            ffn_partial = bool(self.kept(ffn))
        parallel = {"attn": self._slice(f"layers.{i}.mixer.wq", 1, 0)
                    is not None, "ffn": ffn_partial}
        return lambda sub, ys: self.psum(ys) if parallel[sub] else ys

    # -- the MoE over the workers ---------------------------------------------

    def _moe_plan(self, i: int) -> types.SimpleNamespace:
        """Layer i's MoE split by worker: ``experts[m]`` (lo, n) and
        ``shared[m]`` (lo, n) of the shared MLP's hidden dimension, or
        None where worker m adds no shared output; ``partial``: whether the
        layer's outputs are a partial sum over ``model`` for the reduce
        hook (the island sums its own)."""
        cfg, M = self.cfg, self.mesh.size
        E = cfg.num_experts
        pre = f"layers.{i}.ffn."
        f = (self.layouts[pre + "shared.wi"].shape[1]
             if pre + "shared.wi" in self.layouts else 0)
        mp = len(self.groups[0])
        if cfg.moe_sharded:
            if E % mp or f % mp:
                raise ValueError(f"{cfg.arch_id}: the expert-parallel island "
                                 f"splits {E} experts and a shared hidden "
                                 f"of {f} over model = {mp}")
            co = self.model_coord
            return types.SimpleNamespace(
                experts=[(c * E // mp, E // mp) for c in co],
                shared=[(c * f // mp, f // mp) for c in co], partial=False)
        span = lambda s, n: (0, n) if s is None else (  # noqa: E731
            s.start, s.stop - s.start)
        es = [self._slice(pre + "wi", 0, m) for m in range(M)]
        ss = [self._slice(pre + "shared.wi", 1, m) if f else None
              for m in range(M)]
        partial = any(s is not None for s in es + ss)
        # where the layer's output is a partial sum, a part a worker holds
        # whole is added by the first worker of its model group alone
        alone = [partial and self.model_coord[m] > 0 for m in range(M)]
        return types.SimpleNamespace(
            experts=[(0, 0) if es[m] is None and alone[m] else
                     span(es[m], E) for m in range(M)],
            shared=[None if ss[m] is None and alone[m] else span(ss[m], f)
                    for m in range(M)],
            partial=partial)

    def _local_moe(self, ffn, i: int, m: int):
        """Worker m's MoE weights: its experts of ``wi``/``wg``/``wo`` and
        its slice of the shared MLP, narrowed from the gathered copies
        where the layout did not slice them; no ``shared`` where another
        worker adds the shared output."""
        plan = self.moe[i]
        (lo, n), sh = plan.experts[m], plan.shared[m]
        out = types.SimpleNamespace(**vars(ffn))
        for w in ("wi", "wg", "wo"):
            t = getattr(ffn, w)
            if t.shape[0] != n:
                setattr(out, w, t.narrow(0, lo, n))
        if hasattr(ffn, "shared"):
            if sh is None:
                del out.shared
            elif ffn.shared.wi.shape[1] != sh[1]:
                s = ffn.shared
                out.shared = types.SimpleNamespace(
                    wi=s.wi.narrow(1, *sh), wg=s.wg.narrow(1, *sh),
                    wo=s.wo.narrow(0, *sh))
        return out

    def _moe_split(self, i: int, blay: Layout, seq: int) -> MoESplit | None:
        """Layer i's ``MoESplit`` for a step on the batch laid out by
        ``blay`` (None: not an MoE layer, or one worker)."""
        if i not in self.moe or self.mesh.size == 1 and not \
                self.cfg.moe_sharded:
            return None
        M = self.mesh.size
        experts = self.moe[i].experts
        rows = [blay.index(m)[0] for m in range(M)]
        if self.cfg.moe_sharded:
            if "model" not in blay.axes():
                return MoESplit(experts, reduce=self.psum)
            # zero3_dp: a data shard's rows gathered over model, and each
            # worker's own rows back after the psum
            start = {m: rows[m].start - rows[g[0]].start
                     for g in self.groups for m in g}

            def reduce(ys):
                return [y[start[m]:start[m] + rows[m].stop - rows[m].start]
                        for m, y in enumerate(self.psum(ys))]

            return MoESplit(
                experts, reduce=reduce,
                gather=lambda xs: collectives.gather_rows_groups(
                    xs, self.groups, self.traffic))
        starts = sorted({r.start for r in rows})
        slices = [starts.index(r.start) for r in rows]
        exchange = None
        if len(starts) > 1:
            def exchange(counts):
                return collectives.prefix_counts(counts, slices,
                                                 self.traffic)
        return MoESplit(experts, tokens=blay.shape[0] * seq,
                        exchange=exchange)
