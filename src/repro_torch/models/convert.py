"""Weights carried across from the reference's parameter tree.

``params_from_numpy(cfg, tree)`` takes the reference's
``unbox(init_model(key, cfg))`` tree with numpy leaves:

    {"embed": {"embedding"}, "groups": [group, ...], "ln_f": {"scale"},
     "lm_head"}

(with a frontend also ``"frontend": {"proj"}``; the audio frontend's
tree has no ``"embed"``), where ``groups[g]`` holds one run of identical
layer specs and, when the run has more than one layer, every leaf is
stacked along a leading axis (``repro.models.blocks.stack_boxed``).  The
port keeps one module per layer, so the groups are unstacked into
``layers.<i>``.  Every other name is the same on both sides
(``layers.<i>.mixer.wq`` ↔ ``mixer/wq``).
``params_to_numpy`` is the inverse.  ``train_state_from_numpy`` and
``train_state_to_numpy`` carry a training state — the parameters and the
AdamW ``step``, ``m`` and ``v``, whose trees are the parameters' — across
the same way, so both packages can start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from .blocks import group_specs, layer_specs
from .model import Model, init_model


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _nest(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flat_from_tree(cfg, tree: dict) -> dict[str, np.ndarray]:
    """The reference's parameter-shaped tree as port names → leaves (the
    layer groups unstacked into ``layers.<i>``)."""
    flat = _flatten({k: v for k, v in tree.items() if k != "groups"})
    groups = group_specs(layer_specs(cfg))
    if len(tree["groups"]) != len(groups):
        raise ValueError(f"{len(tree['groups'])} layer groups in the tree, "
                         f"{len(groups)} in the config")
    li = 0
    for (_, count), group in zip(groups, tree["groups"]):
        for name, val in _flatten(group).items():
            for j in range(count):
                flat[f"layers.{li + j}.{name}"] = val[j] if count > 1 else val
        li += count
    return flat


def tree_from_flat(cfg, state: dict[str, np.ndarray]) -> dict:
    """Port names → leaves as the reference's tree (groups stacked)."""
    top = {k: v for k, v in state.items() if not k.startswith("layers.")}
    tree = _nest(top)
    groups = []
    li = 0
    for _, count in group_specs(layer_specs(cfg)):
        names = [k.split(".", 2)[2] for k in state
                 if k.startswith(f"layers.{li}.")]
        flat = {}
        for name in names:
            vals = [state[f"layers.{li + j}.{name}"] for j in range(count)]
            flat[name] = np.stack(vals) if count > 1 else vals[0]
        groups.append(_nest(flat))
        li += count
    tree["groups"] = groups
    return tree


def params_from_numpy(cfg, tree: dict, device=None) -> Model:
    """The reference's parameter tree (numpy leaves) as a port ``Model``."""
    flat = flat_from_tree(cfg, tree)
    model = init_model(cfg, device=device)
    state = model.state_dict()
    if set(state) != set(flat):
        raise ValueError(
            "parameter names differ: only in the port "
            f"{sorted(set(state) - set(flat))}, only in the tree "
            f"{sorted(set(flat) - set(state))}")
    with torch.no_grad():
        for name, t in state.items():
            src = torch.from_numpy(np.array(flat[name]))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} in the "
                                 f"tree, {tuple(t.shape)} in the port")
            t.copy_(src)
    return model


def params_to_numpy(model: Model, cfg) -> dict:
    """The port's weights as the reference's tree (groups stacked)."""
    return tree_from_flat(cfg, {k: v.detach().cpu().numpy() for k, v in
                                 model.state_dict().items()})


def train_state_from_numpy(cfg, state, device=None):
    """The reference's ``TrainState(params, AdamWState(step, m, v))`` with
    numpy leaves (or any ``(params, (step, m, v))`` nesting of them) as
    the port's ``launch.steps.TrainState``: the parameters take gradients,
    the moments are f32 and the step an int32 scalar on ``device``."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import AdamWState

    params_tree, (step, m_tree, v_tree) = state
    params = params_from_numpy(cfg, params_tree, device)
    for p in params.parameters():
        p.requires_grad_(True)
    names = dict(params.named_parameters())

    def moments(tree):
        flat = flat_from_tree(cfg, tree)
        if set(flat) != set(names):
            raise ValueError("moment names differ from the parameters': "
                             f"{sorted(set(flat) ^ set(names))}")
        return {n: torch.from_numpy(np.array(flat[n], np.float32)).to(
            t.device) for n, t in names.items()}

    dev = next(iter(names.values())).device
    return TrainState(params, AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        moments(m_tree), moments(v_tree)))


def train_state_to_numpy(state, cfg) -> tuple:
    """The port's ``TrainState`` as ``(params, (step, m, v))`` in the
    reference's trees (groups stacked), numpy leaves."""
    host = lambda d: {k: v.detach().cpu().numpy()   # noqa: E731
                      for k, v in d.items()}
    opt = state.opt
    return (params_to_numpy(state.params, cfg),
            (np.asarray(int(opt.step), np.int32),
             tree_from_flat(cfg, host(opt.m)),
             tree_from_flat(cfg, host(opt.v))))
