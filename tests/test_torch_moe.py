"""The port's MoE layer against the live JAX reference, on the CPU.

``models.moe`` against ``repro.models.moe`` on the reduced DeepSeek-V2-Lite
and Qwen3-MoE configs, inputs from numpy.  The reference's
``_dispatch_indices`` fills its index matrix with the sentinel T·K and
then scatters the arrival indices into it with a maximum, so the sentinel
wins every slot and its routed experts add exactly 0 (ROADMAP.md, Queue
3).  The parity target is the reference with that fill corrected to −1
(``_fixed_dispatch``, monkeypatched in at run time; no reference file is
edited); ``test_reference_routed_output_is_zero`` records the fault.

Tolerances, max |Δ| over max |reference|: f32 1e-5 (f32 products summed
in another order); bf16 inputs 2⁻⁵ (``tests/test_torch_lm_model.py``'s
``TOL``: the expert buffers and products are f32 on both sides, only x is
rounded).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deepseek_v2_lite_16b import REDUCED as J_DS
from repro.configs.qwen3_moe_30b_a3b import REDUCED as J_QM
from repro.models import moe as j_moe
from repro.models import unbox
from repro_torch.configs.deepseek_v2_lite_16b import REDUCED as DS
from repro_torch.configs.qwen3_moe_30b_a3b import REDUCED as QM
from repro_torch.models import moe

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def _fixed_dispatch(expert_ids, num_experts, capacity):
    """The reference's ``_dispatch_indices`` with the fill it meant (−1)."""
    T, K = expert_ids.shape
    flat = expert_ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    slot = jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0]
    keep = slot < capacity
    index_mat = jnp.full((num_experts, capacity), -1, jnp.int32)
    index_mat = index_mat.at[
        jnp.where(keep, flat, num_experts - 1),
        jnp.where(keep, slot, capacity - 1),
    ].max(jnp.where(keep, jnp.arange(T * K, dtype=jnp.int32), -1))
    index_mat = jnp.where(index_mat < 0, T * K, index_mat)
    return index_mat, keep.reshape(T, K), slot.reshape(T, K)


@pytest.fixture
def fixed_reference(monkeypatch):
    monkeypatch.setattr(j_moe, "_dispatch_indices", _fixed_dispatch)


def _brute_force(ids: np.ndarray, E: int, C: int):
    """Slots by a per-pick loop over the arrival order (token, then pick)."""
    T, K = ids.shape
    used = [0] * E
    slot = np.zeros((T, K), np.int64)
    keep = np.zeros((T, K), bool)
    index_mat = np.full((E, C), T * K, np.int64)
    for t in range(T):
        for j in range(K):
            e = int(ids[t, j])
            slot[t, j] = used[e]
            used[e] += 1
            if slot[t, j] < C:
                keep[t, j] = True
                index_mat[e, slot[t, j]] = t * K + j
    return index_mat, keep, slot


def _ids(rng, T, K, E, ties: bool):
    """(T, K) expert picks: distinct in a row, as a top-k gives them; with
    ``ties`` every row picks among the same three experts."""
    pool = 3 if ties else E
    return np.stack([rng.permutation(pool)[:K] for _ in range(T)]).astype(
        np.int32)


@pytest.mark.parametrize("T,K,E,cf,ties", [
    (32, 2, 8, 1.25, False), (32, 2, 8, 0.25, False), (7, 3, 5, 1.0, True),
    (64, 6, 64, 1.25, False), (4, 6, 64, 1.25, False), (40, 2, 8, 0.25, True)])
def test_dispatch_indices_match_reference_and_brute_force(T, K, E, cf, ties):
    rng = np.random.default_rng(T * K + E)
    ids = _ids(rng, T, K, E, ties)
    C = int(T * K / E * cf) + 1
    index_mat, keep, slot = moe.dispatch_indices(torch.from_numpy(ids), E, C)
    j_idx, j_keep, j_slot = j_moe._dispatch_indices(jnp.asarray(ids), E, C)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    f_idx, _, _ = _fixed_dispatch(jnp.asarray(ids), E, C)
    np.testing.assert_array_equal(index_mat.numpy(), np.asarray(f_idx))
    b_idx, b_keep, b_slot = _brute_force(ids, E, C)
    np.testing.assert_array_equal(index_mat.numpy(), b_idx)
    np.testing.assert_array_equal(keep.numpy(), b_keep)
    np.testing.assert_array_equal(slot.numpy(), b_slot)
    if cf < 1:
        assert not keep.all()          # these cases drop picks


def test_reference_dispatch_fault_fills_every_slot_with_the_sentinel():
    """The reference's index matrix is all T·K (every slot empty) while
    its keep and slot are right; the port's holds the arrivals."""
    ids = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    j_idx, j_keep, j_slot = j_moe._dispatch_indices(jnp.asarray(ids), 3, 4)
    assert (np.asarray(j_idx) == 6).all()
    index_mat, keep, slot = moe.dispatch_indices(torch.from_numpy(ids), 3, 4)
    np.testing.assert_array_equal(index_mat.numpy(), [[0, 4, 6, 6],
                                                      [1, 2, 6, 6],
                                                      [3, 5, 6, 6]])
    assert keep.all() and np.asarray(j_keep).all()
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))


def test_top_k_orders_ties_by_the_lower_index_as_jax():
    x = np.array([[0.1, 0.5, 0.5, 0.2, 0.5], [1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.3, 0.2, 0.3, 0.9, 0.2]], np.float32)
    vals, ids = moe.top_k(torch.from_numpy(x), 3)
    j_vals, j_ids = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


def _layer(cfg, jcfg, seed: int, tie: bool = False):
    """(reference params tree, port MoE) with the same weights; ``tie``
    makes router columns 3 and 5 equal, so those experts tie exactly."""
    tree = jax.tree.map(np.asarray, unbox(
        j_moe.init_moe(jax.random.PRNGKey(seed), jcfg)))
    if tie:
        tree["router"] = tree["router"].copy()
        tree["router"][:, 5] = tree["router"][:, 3]
    layer = moe.init_moe(cfg, torch.Generator().manual_seed(seed), "cpu")
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    state = layer.state_dict()
    assert set(state) == set(flat)
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(torch.from_numpy(np.array(flat[name])))
    return tree, layer


def _close(got: torch.Tensor, want, tol: float) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= tol, rel
    return rel


CASES = {   # name: (config, reference config, changes)
    "deepseek": (DS, J_DS, {}),
    "deepseek_no_shared": (DS, J_DS, {"num_shared_experts": 0}),
    "deepseek_norm_topk": (DS, J_DS, {"norm_topk_prob": True}),
    "qwen3_moe": (QM, J_QM, {}),
    "qwen3_moe_no_norm": (QM, J_QM, {"norm_topk_prob": False}),
    "qwen3_moe_shared": (QM, J_QM, {"num_shared_experts": 1}),
    "deepseek_drops": (DS, J_DS, {"capacity_factor": 0.25}),
    "qwen3_moe_drops": (QM, J_QM, {"capacity_factor": 0.25}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_fixed_reference(case, dtype, fixed_reference):
    base, jbase, change = CASES[case]
    cfg = dataclasses.replace(base, **change)
    jcfg = dataclasses.replace(jbase, **change)
    tree, layer = _layer(cfg, jcfg, seed=len(case))
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = j_moe.moe_ffn(tree, jcfg, jx)
    got = moe.moe_ffn(layer, cfg, tx)
    assert got.dtype == torch.float32     # promoted to the f32 weights
    _close(got, want, TOL[dtype])
    # the routed part is live: not the shared experts' output alone
    routed = got - (moe.mlp(layer.shared, tx, cfg.activation)
                    if hasattr(layer, "shared") else 0)
    assert routed.abs().max().item() > 0.0
    _, _, ids = moe.route(layer, cfg, tx.reshape(-1, cfg.d_model))
    _, keep, _ = moe.dispatch_indices(ids, cfg.num_experts,
                                      moe.capacity(cfg, 32))
    if cfg.capacity_factor < 1:
        assert not keep.all()


@pytest.mark.parametrize("softmax_first", [True, False])
def test_moe_ffn_with_tied_router_scores(softmax_first, fixed_reference):
    """Experts 3 and 5 score exactly alike for every token: the picks
    take the lower index first on both sides, so the same picks drop."""
    change = {"router_softmax_then_topk": softmax_first,
              "capacity_factor": 0.5}
    cfg = dataclasses.replace(DS, **change)
    jcfg = dataclasses.replace(J_DS, **change)
    tree, layer = _layer(cfg, jcfg, seed=7, tie=True)
    x = np.random.default_rng(7).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    logits, _, ids = moe.route(layer, cfg, tx.reshape(-1, cfg.d_model))
    assert torch.equal(logits[:, 3], logits[:, 5])
    _close(moe.moe_ffn(layer, cfg, tx),
           j_moe.moe_ffn(tree, jcfg, jnp.asarray(x)), TOL["float32"])


def test_capacity_is_the_reference_formula():
    full_ds = dataclasses.replace(DS, num_experts=64, top_k=6)
    full_qm = dataclasses.replace(QM, num_experts=128, top_k=8)
    assert moe.capacity(full_ds, 4) == 1 == moe.capacity(full_qm, 4)
    assert moe.capacity(full_ds, 8192) == int(8192 * 6 / 64 * 1.25) + 1 \
        == 961
    assert moe.capacity(full_qm, 8192) == 641


def test_reference_routed_output_is_zero():
    """The reference's fault, recorded: its routed experts add exactly 0
    (Qwen3-MoE has no shared experts, so its whole output is 0; DeepSeek's
    is its shared experts' alone).  The port's routed output is not 0."""
    x = np.random.default_rng(3).normal(size=(2, 16, 64)).astype(np.float32)
    tree, layer = _layer(QM, J_QM, seed=3)
    want = np.asarray(j_moe.moe_ffn(tree, J_QM, jnp.asarray(x)))
    assert np.abs(want).max() == 0.0
    got = moe.moe_ffn(layer, QM, torch.from_numpy(x))
    assert got.abs().max().item() > 0.0

    tree, layer = _layer(DS, J_DS, seed=4)
    want = np.asarray(j_moe.moe_ffn(tree, J_DS, jnp.asarray(x)))
    shared = np.asarray(j_moe.mlp(tree["shared"], jnp.asarray(x),
                                  J_DS.activation))
    np.testing.assert_array_equal(want, shared)
    got = moe.moe_ffn(layer, DS, torch.from_numpy(x))
    routed = got - moe.mlp(layer.shared, torch.from_numpy(x), DS.activation)
    assert routed.abs().max().item() > 0.0


@pytest.mark.parametrize("case", ["deepseek", "qwen3_moe"])
def test_load_balance_loss_matches_reference(case):
    cfg, jcfg, _ = CASES[case]
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(64, cfg.num_experts)).astype(np.float32)
    ids = np.stack([rng.permutation(cfg.num_experts)[:cfg.top_k]
                    for _ in range(64)]).astype(np.int32)
    want = j_moe.load_balance_loss(jnp.asarray(logits), jnp.asarray(ids),
                                   cfg.num_experts)
    got = moe.load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(ids), cfg.num_experts)
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


def test_moe_parameters_carry_the_reference_axes():
    tree = j_moe.init_moe(jax.random.PRNGKey(0), J_DS)
    layer = moe.init_moe(DS, torch.Generator().manual_seed(0), "cpu")
    assert layer.router.axes == tree["router"].axes == ("embed", None)
    for name in ("wi", "wg", "wo"):
        assert getattr(layer, name).axes == tree[name].axes
    for name in ("wi", "wg", "wo"):
        assert getattr(layer.shared, name).axes == tree["shared"][name].axes
        assert tuple(getattr(layer.shared, name).shape) == \
            tree["shared"][name].value.shape
