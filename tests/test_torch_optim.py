"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's.

The same numpy parameters and gradients, drawn from a seed, go through
``repro.optim.adamw`` and the port; the port updates its tensors in place.
Tolerance: 1e-6 relative (max |Δ| over max |reference| per leaf) — the
same f32 expressions, where only the order of the global norm's sum over
leaves and fused multiply-adds may differ.  Also the reference's own
checks of ``tests/test_optim.py`` (quadratic convergence, warmup and
decay, the clip bound), held against the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

RTOL = 1e-6


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "emb": (rng.normal(size=(11, 3)) * scale).astype(np.float32)}


@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1),
    adamw.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=20),
    adamw.AdamWConfig(),
])
def test_schedule_matches_reference(cfg):
    jcfg = jadamw.AdamWConfig(**cfg.__dict__)
    for s in [0, 1, 5, 10, 50, 99, 100, 20_000]:
        got = float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(jadamw.schedule(jcfg, jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= RTOL * max(abs(want), 1e-30), (s, got, want)


def test_init_and_global_norm_match_reference():
    tree = _tree(0)
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    st = adamw.init(port)
    jst = jadamw.init({k: jnp.asarray(v) for k, v in tree.items()})
    assert st.step.dtype == torch.int32 and int(st.step) == int(jst.step)
    for k in tree:
        assert st.m[k].dtype == st.v[k].dtype == torch.float32
        assert not st.m[k].any() and not st.v[k].any()
        assert st.m[k].shape == jst.m[k].shape
    got = float(adamw.global_norm(port))
    want = float(jadamw.global_norm({k: jnp.asarray(v)
                                     for k, v in tree.items()}))
    assert abs(got - want) <= RTOL * want


@pytest.mark.parametrize("grad_scale", [1.0, 100.0])   # unclipped, clipped
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_updates_match_reference(grad_scale, dtype):
    """Five steps on fed gradients, f32 parameters and bf16 ones (the
    update in f32, rounded to the parameter's dtype: bf16 parameters are
    held to one bf16 ulp, 2⁻⁸ of the largest)."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    jcfg = jadamw.AdamWConfig(**cfg.__dict__)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tree = _tree(1)
    jp = {k: jnp.asarray(v, jdt) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in tree.items()}
    jst, st = jadamw.init(jp), adamw.init(tp)
    ptol = 2.0 ** -8 if dtype == "bfloat16" else RTOL
    for i in range(5):
        grads = _tree(10 + i, grad_scale)
        jp, jst, jm = jadamw.update({k: jnp.asarray(v)
                                     for k, v in grads.items()}, jst, jp,
                                    jcfg)
        tp, st, m = adamw.update({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, st, tp, cfg)
        assert int(st.step) == int(jst.step) == i + 1
        for name in ("grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= RTOL * abs(
                float(jm[name]))
        for k in tree:
            assert tp[k].dtype == tdt
            assert _rel(tp[k].float(), np.asarray(jp[k], np.float32)) <= ptol
            assert _rel(st.m[k], jst.m[k]) <= RTOL
            assert _rel(st.v[k], jst.v[k]) <= RTOL


def test_update_refuses_mismatched_names():
    p = {"w": torch.zeros(3)}
    with pytest.raises(ValueError, match="names"):
        adamw.update({"x": torch.zeros(3)}, adamw.init(p), p,
                     adamw.AdamWConfig())


# the reference's own checks (tests/test_optim.py), on the port

def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, min_lr_ratio=1.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2.0 * (params["w"] - target)}
        params, state, _ = adamw.update(grads, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s)))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0, abs=1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=1e-3)


def test_grad_clip_bounds_update():
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw.update(huge, state, params, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # reported unclipped


def test_update_takes_a_module_and_keeps_its_parameters():
    """An ``nn.Module`` stands for its named parameters; the update writes
    into them (no new tensors)."""
    lin = torch.nn.Linear(3, 2)
    before = {n: p.detach().clone() for n, p in lin.named_parameters()}
    ids = {n: p.data_ptr() for n, p in lin.named_parameters()}
    st = adamw.init(lin)
    grads = {n: torch.ones_like(p) for n, p in lin.named_parameters()}
    adamw.update(grads, st, lin, adamw.AdamWConfig(lr=0.1, warmup_steps=0))
    for n, p in lin.named_parameters():
        assert p.data_ptr() == ids[n]
        assert not torch.equal(p.detach(), before[n])
