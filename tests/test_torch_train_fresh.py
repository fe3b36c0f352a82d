"""Four AdamW steps on fresh batches for the families beside dense, the
port's ``launch.train.train_step`` against the reference's ``main`` step
(``src/repro/launch/train.py``'s jitted ``step_fn``:
``jax.value_and_grad(model.loss_fn)`` then ``adamw_update``), at the smoke
configs of deepseek-moe-16b, mamba2-1.3b, recurrentgemma-9b, hubert-xlarge
and phi-3-vision-4.2b.

Both sides start from the reference's initial weights (carried over by
``interop``) and take one seeded numpy batch a step, a different one each
step (``tests/test_torch_train_families.py``'s ``_batch``: stub frames for
hubert, stub patches for phi-3-vision), at lr 3e-4 (the reference driver's
default) and 3e-5 (``chip_smoke.py`` phase 15's).  Every step's loss is
held within ``LOSS_RTOL`` of the reference's, the bound of
``tests/test_torch_train.py``.

The MoE records the reference's expert choices in each step (a
``jax.debug.callback`` beside ``route_topk``) and replays them in the port's
step, with ``remat="none"`` on both sides, as the family test does.

What this pins: on fresh batches the loss rises at the second step in
the reference as in the port, in every family and at both rates (the
losses of both are printed with ``-s``), so such a rise on the card is
not a fault of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train_step  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from test_torch_train import LOSS_RTOL  # noqa: E402
from test_torch_train_families import _batch, _j_batch, _t_batch  # noqa: E402

ARCHS = ["deepseek-moe-16b", "mamba2-1.3b", "recurrentgemma-9b",
         "hubert-xlarge", "phi-3-vision-4.2b"]
LRS = [3e-4, 3e-5]
STEPS = 4
SEED0 = 100          # step i takes the batch of seed SEED0 + i


@dataclasses.dataclass
class Arch:
    """One family's models, the reference's initial weights (as JAX arrays
    and as numpy) and its jitted ``main`` step with ``lr`` an argument, so
    that both rates run one compiled step."""
    tcfg: object
    jp: object
    numpy_params: object
    tm: object
    step_fn: object
    choices: list


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """Built once per family.  The MoE's reference step records its expert
    choices (a ``jax.debug.callback`` beside ``route_topk``, patched while
    this family's cases run; JAX's caches are cleared once so that the
    step is traced through the patch)."""
    name = request.param
    jcfg, tcfg = j_get_config(name, smoke=True), get_config(name, smoke=True)
    moe = tcfg.family == "moe"
    if moe:
        jcfg = dataclasses.replace(jcfg, remat="none")
        tcfg = dataclasses.replace(tcfg, remat="none")
    jm = JModel(jcfg)
    jp = unbox(jm.init(jax.random.key(0)))
    choices = []

    @jax.jit
    def step_fn(params, opt, batch, lr):
        (loss, _), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
            params, batch)
        params, opt, gnorm = j_adamw_update(params, grads, opt, lr=lr)
        return params, opt, loss

    with pytest.MonkeyPatch.context() as mp:
        if moe:
            route = jmoe.route_topk

            def recording(logits, top_k):
                w, ix = route(logits, top_k)
                jax.debug.callback(lambda a: choices.append(np.array(a)), ix)
                return w, ix
            mp.setattr(jmoe, "route_topk", recording)
            jax.clear_caches()
        yield Arch(tcfg, jp, jax.tree.map(np.asarray, jp),
                   Model(tcfg, device="cpu"), step_fn, choices)


def fresh_losses(a: Arch, lr: float):
    """``(reference losses, port losses)`` of ``STEPS`` steps at ``lr``,
    a fresh batch each step, both from the reference's initial weights."""
    moe = a.tcfg.family == "moe"
    params = interop.params_from_numpy(a.numpy_params, "cpu")
    opt = adamw_init(params)
    jp, jopt = a.jp, j_adamw_init(a.jp)
    want, got = [], []
    for i in range(STEPS):
        batch = _batch(a.tcfg, seed=SEED0 + i)
        del a.choices[:]
        jp, jopt, jl = a.step_fn(jp, jopt, _j_batch(batch, False), lr)
        want.append(float(jl))
        jax.effects_barrier()
        assert len(a.choices) == (a.tcfg.n_layers if moe else 0)
        if moe:
            with tmoe.pinned_routing(replay=list(a.choices)) as flips:
                params, opt, loss, _, _ = train_step(
                    a.tm, params, opt, _t_batch(batch, False), (), lr, False)
            assert flips[0] <= 0.1 * flips[1], flips
        else:
            params, opt, loss, _, _ = train_step(
                a.tm, params, opt, _t_batch(batch, False), (), lr, False)
        got.append(float(loss))
    return want, got


@pytest.mark.parametrize("lr", LRS)
def test_fresh_batch_steps_match_reference(arch, lr):
    want, got = fresh_losses(arch, lr)
    name = arch.tcfg.name
    print(f"{name} lr {lr}: reference {want}, port {got}")
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                               err_msg=f"{name} lr {lr}")
    # the rise at the second step that the card showed, in both packages
    assert want[1] > want[0] and got[1] > got[0], (want, got)
