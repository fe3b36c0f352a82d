"""The port's loss and gradients on the CPU against the JAX reference for
the families beside dense, at their smoke configs: here moe
``deepseek-moe-16b`` (with its auxiliary loss), encoder ``hubert-xlarge``
(audio stub features) and vlm ``phi-3-vision-4.2b`` (vision stub patches,
whose positions carry no loss); ssm and hybrid in
``tests/test_torch_train_recurrent.py``, which calls ``check_family``.
The reference's initial weights are carried into the port by ``interop``;
tokens, targets and stub features are drawn by numpy.  Each runs twice:

* bf16 (the weights as initialised): each gradient leaf within ``|g_port -
  g_ref| / |g_ref|`` <= 2e-2 (norms over the leaf), the loss within rtol
  2e-3, the bound of ``tests/test_torch_train.py``, for the same reason
  (bf16 activations rounded at other places by XLA and PyTorch).  The
  hybrid alone is held to 6e-2 (``FAMILY_BOUND``): its smoke config has
  five layers, three of them recurrent, and its bf16 forward already
  differs by more (``tests/test_torch_models.py`` holds its logits to
  rtol 1e-1); every leaf of its gradient is off by 2-5 %, lm_head and
  final_norm included, which is that difference in the logits carried
  back, not one layer's fault.
* f32 (every weight and stub feature cast to f32 on both sides): the same
  algorithm without bf16 rounding, each leaf within 1e-4, the loss within
  1e-5 (the hybrid's leaves came within 2.4e-6).

The MoE's top-k routing flips at near-ties under any change of rounding
(``tests/test_torch_models.py``), so the reference's expert choices are
recorded as its ``loss_fn`` runs (a ``jax.debug.callback`` beside its
``route_topk``, with JAX's caches cleared so that it is traced) and replayed in the port (``moe.pinned_routing``).  Both
sides run that family with ``remat="none"``: a checkpointed block routes
again in the backward, and the replay holds one choice per layer.
``tests/test_torch_train.py`` holds remat against no remat.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

B, S = 2, 32
ARCHS = ["deepseek-moe-16b", "hubert-xlarge", "phi-3-vision-4.2b"]
# dtype -> (loss rtol, gradient leaf bound)
BOUNDS = {"bf16": (2e-3, 2e-2), "f32": (1e-5, 1e-4)}
FAMILY_BOUND = {("hybrid", "bf16"): 6e-2}    # see the module docstring


def _batch(cfg, seed=3):
    """Numpy tokens, targets and stub features of a batch of ``S``
    positions: the encoder takes S frames and no tokens, the vlm
    ``n_patches`` patches before ``S`` text tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend:
        n = S if cfg.frontend == "audio" else cfg.n_patches
        out["frontend"] = rng.standard_normal(
            (B, n, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encoder":
        out["tokens"] = np.zeros((B, 0), np.int32)
    return out


def _j_batch(b, f32: bool):
    dt = jnp.float32 if f32 else jnp.bfloat16
    return {k: jnp.asarray(v, dt if k == "frontend" else None)
            for k, v in b.items()}


def _t_batch(b, f32: bool):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if "frontend" in out and not f32:
        out["frontend"] = torch.from_numpy(np.array(jnp.asarray(
            b["frontend"], jnp.bfloat16).astype(jnp.float32))).to(
                torch.bfloat16)
    return out


def check_family(arch: str, dtype: str, monkeypatch,
                 over: dict | None = None, aux_rtol: float = 1e-4,
                 leaf_bounds: dict | None = None) -> None:
    """Loss and every gradient leaf of ``arch``'s smoke config (with the
    fields ``over`` names replaced on both sides) against the reference's,
    in ``dtype`` ("bf16" or "f32"), within ``BOUNDS`` (a leaf that
    ``leaf_bounds`` names within its bound there); an MoE's auxiliary loss
    within ``aux_rtol``."""
    f32 = dtype == "f32"
    jcfg, tcfg = (dataclasses.replace(c, **(over or {})) for c in (
        j_get_config(arch, smoke=True), get_config(arch, smoke=True)))
    moe = tcfg.family == "moe"
    if moe:
        jcfg = dataclasses.replace(jcfg, remat="none")
        tcfg = dataclasses.replace(tcfg, remat="none")
    jm = JModel(jcfg)
    jp = unbox(jm.init(jax.random.key(0)))
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = _batch(tcfg)
    loss_rtol, bound = BOUNDS[dtype]
    bound = FAMILY_BOUND.get((tcfg.family, dtype), bound)
    choices = []
    if moe:
        route = jmoe.route_topk

        def recording(logits, top_k):
            w, ix = route(logits, top_k)
            jax.debug.callback(lambda a: choices.append(np.array(a)), ix)
            return w, ix
        monkeypatch.setattr(jmoe, "route_topk", recording)
        # ``moe_ffn`` is jitted: a trace cached by an earlier test in this
        # process would skip the recording ``route_topk``
        jax.clear_caches()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, _j_batch(batch, f32))
    jax.effects_barrier()
    assert len(choices) == (tcfg.n_layers if moe else 0)

    tm = Model(tcfg, device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True),
                      interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                "cpu"))
    if moe:
        with tmoe.pinned_routing(replay=choices) as flips:
            loss, met = tm.loss_fn(params, _t_batch(batch, f32))
        assert flips[1] > 0 and flips[0] <= 0.1 * flips[1], flips
        assert float(met["aux"]) > 0
        np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                                   rtol=aux_rtol)
    else:
        loss, met = tm.loss_fn(params, _t_batch(batch, f32))
        assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=loss_rtol)
    leaves = tree_leaves(params)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(
        loss, leaves, materialize_grads=True)))
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(grads)
    for path, want in flat:
        name = "/".join(str(p.key) for p in path)
        leaf = params
        for p in path:
            leaf = leaf[p.key]
        g = grads[id(leaf)].to(torch.float32).numpy().astype(np.float64)
        w = np.asarray(want, np.float64)
        assert g.shape == w.shape, name
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        limit = (leaf_bounds or {}).get(name, bound)
        assert rel <= limit, f"{arch} {dtype}: leaf {name} off by {rel:.3g}"


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype, monkeypatch):
    check_family(arch, dtype, monkeypatch)
