"""Head dims no registered config has, through a whole model on the CPU
against the JAX reference: qwen3-0.6b's smoke config with ``head_dim`` 20
(a bf16 row of 40 bytes, which the card's flash kernels run on padded
copies and its paged kernel loads element by element) and 264 (past the
widest compiled instance: two column passes in all three kernels).  The
reference's weights are carried into the port by
``interop.params_from_numpy``.

* The forward's logits and caches (B 2 x S 64), the prefill's last logits,
  16 decode steps from a zero state and the final decode state, within
  ``tests/test_torch_models.py``'s tolerance.
* One training step: the loss and every gradient leaf in bf16 and f32
  (``tests/test_torch_train_families.py``'s ``check_family`` and its
  bounds).

On the CPU the port runs the kernels' plain versions, which take any head
dim; the same model on the card: ``chip_smoke.py``'s qwen3-0.6b rows at
``head_dim`` 20 and 264 (phases 14 and 15).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from test_torch_models import _check_logits, _check_state  # noqa: E402
from test_torch_models import _tokens  # noqa: E402
from test_torch_train_families import check_family  # noqa: E402

ARCH = "qwen3-0.6b"
HEAD_DIMS = [20, 264]
B, S, STEPS = 2, 64, 16


@pytest.fixture(scope="module", params=HEAD_DIMS, ids=lambda d: f"d{d}")
def qwen(request):
    """(JAX model, JAX params, port model, port params) of qwen3-0.6b's
    smoke config at ``head_dim`` D."""
    over = {"head_dim": request.param}
    jm = JModel(dataclasses.replace(j_get_config(ARCH, smoke=True), **over))
    jp = unbox(jm.init(jax.random.key(0)))
    tm = Model(dataclasses.replace(get_config(ARCH, smoke=True), **over),
               device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tm.cfg.hd == jm.cfg.hd == request.param
    return jm, jp, tm, tp


def test_head_dim_plans_on_the_card():
    """What the card runs these head dims on (``plan_of``): D 20 in bf16
    flash on padded copies 24 wide on the 32-column instance, paged on its
    32-column instance loading the rows itself; D 264 two column passes of
    the 256 instances in every kernel."""
    assert fa.plan_of(20, torch.bfloat16) == (20, 32, 1, True)
    assert pa.plan_of(20, torch.bfloat16) == (20, 32, 1, False)
    for ops in (fa, pa):
        assert ops.plan_of(264, torch.bfloat16) == (264, 256, 2, False)


def test_forward_prefill_and_decode_match_reference(qwen):
    """The forward's logits and caches and the prefill's last logits (B 2
    x S 64, one attention chunk), then 16 decode steps from a zero state,
    each step's logits and the final decode state."""
    jm, jp, tm, tp = qwen
    cfg = tm.cfg
    toks = _tokens(cfg, B, S)
    jl, _, jc = jtfm.forward(jm.cfg, jp, jnp.asarray(toks),
                             return_cache=True)
    tl, _, tc = ttfm.forward(cfg, tp, torch.from_numpy(toks),
                             return_cache=True)
    _check_logits(tl, jl, f"D {cfg.hd} forward", cfg)
    for got, want in zip(tc, jc):
        assert tuple(got.shape) == want.shape and got.shape[-1] == cfg.hd
        _check_state({"c": got}, {"c": want}, cfg, f"D {cfg.hd} cache")
    pl, caches = tm.prefill(tp, torch.from_numpy(toks))
    assert tuple(caches[0].shape) == (cfg.n_layers, B, S, cfg.n_kv, cfg.hd)
    _check_logits(pl, jl[:, -1:], f"D {cfg.hd} prefill", cfg)

    steps = _tokens(cfg, B, STEPS, seed=3)
    jst, tst = jm.init_decode_state(B, STEPS), tm.init_decode_state(B, STEPS)
    jdec = jax.jit(jm.decode_step)
    got, want = [], []
    for t in range(STEPS):
        tok = steps[:, t:t + 1]
        jlg, jst = jdec(jp, jst, jnp.asarray(tok), jnp.int32(t))
        tlg, tst = tm.decode_step(tp, tst, torch.from_numpy(tok), t)
        _check_logits(tlg, jlg, f"D {cfg.hd} decode step {t}", cfg,
                      argmax=False)
        got.append(tlg)
        want.append(np.asarray(jlg, np.float32))
    _check_logits(torch.cat(got, 1), np.concatenate(want, 1),
                  f"D {cfg.hd} decode steps", cfg)
    _check_state(tst, jst, cfg, f"D {cfg.hd} decode state")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_loss_and_grads_match_reference(d, dtype, monkeypatch):
    """One training step's loss and every gradient leaf."""
    check_family(ARCH, dtype, monkeypatch, over={"head_dim": d})
