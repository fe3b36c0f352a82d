"""``repro_torch.core.engine.apply_batch`` against the JAX reference on the
engine's other planes: SNAPSHOT replication (step 5d), baselines without
local write combining, and the reference running its Pallas kernels
(interpret mode) instead of its jnp path.  Same seeded windows and
window-by-window bit-equality as ``test_torch_engine.py``."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.core.types import SyncMode  # noqa: E402
from test_torch_engine import run_both  # noqa: E402


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_apply_batch_replicated(mode):
    run_both(mode, 8, "replicas", seed=1)


@pytest.mark.parametrize("mode", [SyncMode.SPIN, SyncMode.MCS],
                         ids=lambda m: m.name)
def test_apply_batch_without_local_wc(mode):
    run_both(mode, 0, "no_local_wc", seed=2)


@pytest.mark.parametrize("mode", [SyncMode.SPIN, SyncMode.CIDER],
                         ids=lambda m: m.name)
def test_apply_batch_matches_pallas_backend(mode):
    """The reference with its Pallas kernels (interpret mode) next to its
    jnp path: the port equals both."""
    run_both(mode, 8, "crash", seed=3, backend="pallas")
