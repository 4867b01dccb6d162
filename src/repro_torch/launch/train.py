"""LM training driver: state + supervisor + checkpoints, on one device or
sharded over a worker mesh.

Counterpart of ``repro.launch.train`` (language-model configs), with its
flags and ``--tucker-rank`` (Tucker-compress every FFN at that rank),
``--device`` and ``--backend``, as ``launch/serve.py`` has them:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_14b \\
        --reduced --steps 20 --batch 8 --seq 128 --tucker-rank 8 \\
        --ckpt-dir /tmp/ckpt --device cpu --backend torch

Without ``--mesh`` the state lives on one device (``make_train_step``).
``--mesh host`` shards it over ``launch.mesh.make_host_mesh
(--model-parallel)`` — ``$REPRO_FORCE_HOST_DEVICES`` workers (default: one
a visible card), placed round-robin over the cards, ``model_parallel`` of
them on the ``model`` axis — by ``--policy`` (``tp``, ``fsdp_tp`` (the
default), ``fsdp_tp_v2``, ``zero3``, ``zero3_dp``;
``distributed.sharding``), the AdamW moments on their parameters' layouts
(ZeRO), and trains with ``make_sharded_train_step``.  ``--mesh single`` /
``multi`` take the reference's 256- / 512-device production meshes and
raise unless that many cards are visible.  So
``REPRO_FORCE_HOST_DEVICES=4 ... --mesh host --policy fsdp_tp
--model-parallel 2`` trains on a (2, 2) mesh of four workers, on the CPU
with ``--device cpu``, sharing one card, or one a card on four.

Runs on the CUDA card with the ``"cuda"`` kernels by default (backend:
``--backend`` > ``$REPRO_TORCH_KERNEL_BACKEND`` > ``cuda``); without CUDA
it raises unless ``--device cpu`` is given.  Weights come from
``init_model`` with a ``torch.Generator`` on the (first worker's) device
seeded 0 — a sharded state holds the same values as the unsharded one;
batches from the reference's ``TokenPipeline`` (the same tokens for the
same step).  The ``Supervisor`` checkpoints every ``--ckpt-every`` steps
(asynchronously) and, when a step raises, restores the latest checkpoint
and replays from there; ``--resume`` starts from the latest checkpoint in
``--ckpt-dir``.  A checkpoint holds every leaf unsharded, so any mesh and
policy restores what any other wrote.  ``run(cfg, ...)`` is the same
driver for a config built in code.  At full width the f32 AdamW state of
Qwen3-14B's 40 layers (88 GB) does not fit one 80 GB card, so one card
trains ``num_layers`` cut (8 fit); sharded by ``fsdp_tp`` or ``zero3``
over four cards, a worker holds a quarter of it (22 GB).  The MoE models
(``deepseek_v2_lite_16b`` with MLA, ``qwen3_moe_30b_a3b``) and their
``mixed_precision`` forms train on one device and under every policy
(``distributed.sharded_lm.ShardedLM``; ``moe_sharded``, set in code as in
the reference, takes the expert-parallel MoE island).  The dense
Qwen2.5-14B, DeepSeek-67B and StarCoder2-15B train here too, and
InternVL2-2B on its text alone (the pipeline has no patches), as the
reference's ``launch/train.py`` trains it; a frontend's config is refused on
a mesh (``sharded_lm.require_tokens``).  HuBERT-XLarge (the audio frontend)
has no tokens for the pipeline to feed, so ``run`` refuses it: it trains
through ``launch.steps.make_train_step`` on ``input_specs`` batches, the
reference's own way (its ``launch/train.py`` has only the token pipeline
too).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, require_ported
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharded_lm import require_tokens
from repro_torch.distributed.sharding import (POLICIES, ShardedTensor,
                                              shardings_for_tree)
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_model, param_axes
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (FailureInjector, Supervisor,
                                       SupervisorConfig)

log = logging.getLogger("repro_torch.train")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="LM training (language-model configs only).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, choices=["host", "single",
                                                     "multi"],
                    help="shard the state over a worker mesh (default: one "
                         "device)")
    ap.add_argument("--policy", default="fsdp_tp", choices=sorted(POLICIES))
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "in the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tucker-rank", type=int, default=None,
                    help="Tucker-compress every FFN at this rank (default: "
                         "the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "cpu must be asked for)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_batch(batch: dict, device: torch.device) -> dict:
    """The pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def layouts_for(cfg, mesh, policy: str) -> dict:
    """{parameter name: Layout} of ``cfg``'s model on ``mesh`` under
    ``policy`` (the shapes from a model on the ``meta`` device)."""
    shapes = init_model(cfg, device="meta")
    return shardings_for_tree(
        param_axes(shapes), {n: tuple(p.shape) for n, p in
                             shapes.named_parameters()}, mesh, policy)


def build_state(generator: torch.Generator, cfg, mesh, policy: str
                ) -> tuple[S.TrainState, dict]:
    """The training state sharded over ``mesh`` by ``policy`` →
    (state, {parameter name: Layout}).

    The weights are ``init_model``'s from ``generator`` on worker 0's
    device — the unsharded state's values — each leaf cut into its
    workers' parts and then freed; the moments are zeros on the same
    layouts.
    """
    layouts = layouts_for(cfg, mesh, policy)
    model = init_model(cfg, generator, mesh.devices[0])
    params = {}
    for name, p in model.named_parameters():
        params[name] = _sharded(p.detach(), layouts[name], True)
        p.data = torch.empty(0, device=p.device)   # free the full leaf
    return S.TrainState(params, adamw.init(params)), layouts


def shard_state(state: S.TrainState, cfg, mesh, policy: str
                ) -> tuple[S.TrainState, dict]:
    """An unsharded ``TrainState`` copied onto ``mesh`` by ``policy`` →
    (sharded state, layouts); ``state`` is left as it was."""
    layouts = layouts_for(cfg, mesh, policy)
    params = {n: _sharded(p.detach(), layouts[n], True)
              for n, p in state.params.named_parameters()}
    opt = state.opt
    return S.TrainState(params, adamw.AdamWState(
        opt.step.to(mesh.devices[0], copy=True),
        {n: _sharded(t, layouts[n]) for n, t in opt.m.items()},
        {n: _sharded(t, layouts[n]) for n, t in opt.v.items()})), layouts


def _sharded(full: torch.Tensor, layout, grad: bool = False
             ) -> ShardedTensor:
    return ShardedTensor([t.requires_grad_(grad) for t in
                          layout.shard(full)], layout)


def state_shardings(layouts: dict) -> dict:
    """{checkpoint leaf name: Layout} of a sharded ``TrainState`` whose
    parameters are on ``layouts``."""
    return {f"{pre}.{n}": lay for pre in ("params", "opt.m", "opt.v")
            for n, lay in layouts.items()}


def state_bytes_per_worker(layouts: dict) -> int:
    """Bytes of one worker's parts of the f32 parameters, m and v, and the
    int32 step, counted from the layouts' shapes."""
    return 3 * sum(lay.part_bytes(4) for lay in layouts.values()) + 4


def held_bytes(state: S.TrainState, worker: int) -> int:
    """Bytes of the tensors worker ``worker`` holds of a sharded state."""
    total = state.opt.step.numel() * state.opt.step.element_size()
    for tree in (state.params, state.opt.m, state.opt.v):
        for t in tree.values():
            p = t.parts[worker]
            total += p.numel() * p.element_size()
    return total


def run(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
        lr: float = 3e-4, ckpt_dir: str | None = None, ckpt_every: int = 50,
        log_every: int = 10, resume: bool = False, device=None,
        backend: str | None = None,
        injector: FailureInjector | None = None, mesh=None,
        policy: str = "fsdp_tp") -> dict:
    """Train ``steps`` steps (from the latest checkpoint with ``resume``).

    Returns ``history`` (step → its metrics as floats, with ``seconds``,
    the step's wall time closed by a device synchronize; a replayed step
    keeps its last run), the wall ``seconds`` of the loop, ``steps_per_s``
    and ``tokens_per_s`` over the steps run, the peak device bytes (None on
    the CPU), the supervisor's ``stats``, the step it ``started`` from and
    the final ``state``.  ``injector`` raises at chosen steps, before they
    run (the supervisor's restart path).  With a ``mesh`` the state is
    sharded by ``policy`` (``build_state``); the result adds its
    ``layouts``, ``state_bytes_per_worker`` (worker 0's parts of the
    parameters, m, v and the step, as held, and ``layout_state_bytes``
    from the layouts' shapes) and ``traffic_per_step`` (the collectives'
    bytes a worker, ``collectives.Traffic``, over the steps run).
    """
    require_ported(cfg)
    if cfg.frontend == "audio":
        raise ValueError(
            f"{cfg.arch_id}: the audio frontend takes frames, and this "
            "launcher's TokenPipeline feeds tokens only (as the reference's "
            "does); train it through launch.steps.make_train_step on "
            "concretize(input_specs(cfg, cell)) batches")
    if mesh is not None:
        require_tokens(cfg)
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    dispatch.get_backend(backend)  # unknown names raise here
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    layouts = shardings = None
    if mesh is None:
        train_step = S.make_train_step(cfg, opt_cfg, backend)
        state = S.init_train_state(cfg, gen, device)
    else:
        state, layouts = build_state(gen, cfg, mesh, policy)
        shardings = state_shardings(layouts)
        train_step = S.make_sharded_train_step(cfg, opt_cfg, mesh, layouts,
                                               backend, policy=policy)

    ckpt = CheckpointManager(ckpt_dir or os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    sup = Supervisor(ckpt, SupervisorConfig(checkpoint_every=ckpt_every))
    start = 0
    if resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state, shardings=shardings)
        log.info("resumed from step %d", start)

    history: dict[int, dict] = {}
    executed = [0]      # steps run, replays included

    def step_fn(state, i):
        if injector is not None:
            injector.maybe_fail(i)
        t0 = time.perf_counter()
        state, metrics = train_step(state, device_batch(
            pipe.global_batch(i), device))
        m = {k: float(v) for k, v in metrics.items()}   # synchronizes
        m["seconds"] = time.perf_counter() - t0
        history[i + 1] = m
        executed[0] += 1
        if (i + 1) % log_every == 0:
            log.info("step %d loss %.4f gnorm %.3f", i + 1, m["loss"],
                     m["grad_norm"])
        return state

    _sync(device)
    t0 = time.perf_counter()
    state = sup.run(state, step_fn, steps, start_step=start,
                    state_shardings=shardings)
    _sync(device)
    secs = time.perf_counter() - t0
    ran = max(steps - start, 0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    log.info("done: %d steps in %.1fs; restarts=%d stragglers=%d",
             ran, secs, sup.stats.restarts, sup.stats.straggler_steps)
    if history:
        first, last = min(history), max(history)
        log.info("first loss %.4f → last loss %.4f",
                 history[first]["loss"], history[last]["loss"])
    log.info("peak device bytes %s",
             "not measured (CPU)" if peak is None else f"{peak:,}")
    out = {"history": history, "seconds": secs,
           "steps_per_s": ran / max(secs, 1e-9),
           "tokens_per_s": ran * batch * seq / max(secs, 1e-9),
           "peak_device_bytes": peak, "stats": sup.stats, "started": start,
           "state": state, "backend": backend, "device": str(device)}
    if mesh is not None:
        t = train_step.traffic
        traffic = {k: getattr(t, k) / max(executed[0], 1)
                   for k in ("all_gather_bytes", "reduce_scatter_bytes",
                             "all_reduce_bytes", "count_bytes")}
        out.update(layouts=layouts, mesh_shape=mesh.shape, policy=policy,
                   state_bytes_per_worker=held_bytes(state, 0),
                   layout_state_bytes=state_bytes_per_worker(layouts),
                   traffic_per_step=traffic)
        log.info("mesh %s %s: state bytes a worker %s; a step's collective "
                 "bytes a worker %s", mesh.shape, policy,
                 f"{out['state_bytes_per_worker']:,}", traffic)
    return out


def main(argv: list[str] | None = None,
         injector: FailureInjector | None = None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.tucker_rank is not None:
        cfg = dataclasses.replace(cfg, tucker_rank=args.tucker_rank)
    mesh = None
    if args.mesh == "host":
        mesh = make_host_mesh(args.model_parallel, device=args.device)
    elif args.mesh is not None:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, log_every=args.log_every,
               resume=args.resume, device=args.device, backend=args.backend,
               injector=injector, mesh=mesh, policy=args.policy)


if __name__ == "__main__":
    main()
