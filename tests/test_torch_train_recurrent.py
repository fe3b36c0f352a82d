"""The port's loss and gradients on the CPU against the JAX reference for
the recurrent families, ssm ``mamba2-1.3b`` and hybrid
``recurrentgemma-9b``, at their smoke configs, in bf16 and in f32: the
checks and bounds of ``tests/test_torch_train_families.py`` (a file of
their own so that the two spread over the test workers)."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_train_families import check_family  # noqa: E402


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_loss_and_grads_match_reference(arch, dtype, monkeypatch):
    check_family(arch, dtype, monkeypatch)
