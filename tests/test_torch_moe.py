"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against the
JAX reference (``repro.models.moe``): routing and grouping bit for bit on
the same inputs (ties included), ``moe_ffn`` at ``rows`` 1 and 2 with and
without shared experts, capacity drops, the auxiliary loss and
``moe_capacity``.  Inputs come from numpy seeds.

Tolerance of ``moe_ffn``'s output: rtol 2e-2, atol 6.25e-2 (the model
tests'), since both sides round bf16 matmuls and the SiLU product at other
places; the routing, the slots and the drop mask are held bit for bit, and
the aux loss (f32 means and sums over up to 600 tokens, taken in
another order) within rtol 1e-4.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wc_combine import ops as wcc  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

RTOL, ATOL = 2e-2, 6.25e-2


def _bf16(a):
    """(JAX bf16 array, torch bf16 tensor) with the same bits."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(
        np.asarray(a, np.float32)).to(torch.bfloat16)


def _logits(t, e, seed, ties):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((t, e)).astype(np.float32)
    if ties:    # whole rows of equal gates, and pairs tied at the k-th place
        lg[::3] = 0.5
        lg[1::3, 1] = lg[1::3, 4]
        lg = np.round(lg * 4) / 4
    return lg


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (37, 64, 6), (5, 384, 8)])
def test_route_topk_bit_for_bit(t, e, k, ties):
    """The same bf16 logits: experts equal (ties go to the lower expert, as
    ``lax.top_k`` orders them), weights equal to f32 rounding."""
    jl, tl = _bf16(_logits(t, e, t + e, ties))
    jw, jix = jmoe.route_topk(jl, k)
    tw, tix = tmoe.route_topk(tl, k)
    assert tix.dtype == torch.int32
    np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("cap", [1, 3, 128])
@pytest.mark.parametrize("n,e", [(12, 64), (200, 8), (1000, 16)])
def test_group_by_expert_bit_for_bit(n, e, cap):
    """Slots and drop masks of the sort-and-rank dispatch, with capacities
    that drop most lanes, some and none."""
    ids = np.random.default_rng(n + cap).integers(0, e, n).astype(np.int32)
    jslot, jdrop = jmoe._group_by_expert(jnp.asarray(ids), e, cap)
    tslot, tdrop = tmoe._group_by_expert(torch.from_numpy(ids), e, cap)
    assert tslot.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))


def test_group_by_expert_tags_its_rank_launches():
    """On the CPU the rank takes the plain version: no launch is counted,
    under the dispatch's tag or any other."""
    c0 = dict(wcc.counter.by_tag)
    tmoe._group_by_expert(torch.arange(10, dtype=torch.int32) % 3, 3, 4)
    assert wcc.counter.by_tag == c0
    with build.launch_tag("outer"):
        assert build._TAGS[-1] == "outer"
    assert not build._TAGS


def _weights(t, d, e, f, n_shared, seed):
    """x, router, experts (and shared experts).  x and the router weights
    are multiples of 1/8 below 4 in magnitude, so every router logit is an
    exact f32 sum whatever the order of summation, and both sides route by
    the same bf16 logits (ties included)."""
    rng = np.random.default_rng(seed)

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def eighths(a):
        return np.clip(np.round(a * 8) / 8, -3.875, 3.875).astype(np.float32)

    ws = [eighths(rng.standard_normal((t, d))),
          eighths(rng.standard_normal((d, e)) / 2),
          w(e, d, f, fan=d), w(e, d, f, fan=d), w(e, f, d, fan=f)]
    if n_shared:
        fs = f * n_shared
        ws += [w(d, fs, fan=d), w(d, fs, fan=d), w(fs, d, fan=fs)]
    return ws


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("n_shared,cf", [(2, 8.0), (0, 1.25), (1, 0.05)])
def test_moe_ffn_matches_reference(rows, n_shared, cf):
    """Output and aux loss at rows 1 and 2 (the reference vmaps its row
    blocks; the port groups them as a batch axis), with two, no and one
    shared experts; capacity factor 0.05 drops tokens (capacity 128 of 600
    assignments an expert row at rows 1)."""
    t, d, e, f, k = 600, 64, 4, 32, 2
    ws = _weights(t, d, e, f, n_shared, seed=rows + n_shared)
    pairs = [_bf16(a) for a in ws]
    jy, jaux = jmoe.moe_ffn(*[p[0] for p in pairs], top_k=k,
                            capacity_factor=cf, rows=rows)
    ty, taux = tmoe.moe_ffn(*[p[1] for p in pairs], top_k=k,
                            capacity_factor=cf, rows=rows)
    assert ty.dtype == torch.bfloat16 and ty.shape == (t, d)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)


def test_capacity_drops_match_reference():
    """At a capacity factor that drops most assignments, the port drops the
    same (token, expert) lanes: the dropped lanes' contributions are zero,
    so a token with every assignment dropped comes out as zeros in both."""
    t, d, e, f, k = 512, 32, 4, 16, 2
    ws = _weights(t, d, e, f, 0, seed=9)
    pairs = [_bf16(a) for a in ws]
    cap = jmoe.moe_capacity(t, e, k, 0.01)
    assert cap == tmoe.moe_capacity(t, e, k, 0.01) == 128 < t * k // e
    jy, _ = jmoe.moe_ffn(*[p[0] for p in pairs], top_k=k,
                         capacity_factor=0.01)
    ty, _ = tmoe.moe_ffn(*[p[1] for p in pairs], top_k=k,
                         capacity_factor=0.01)
    jzero = np.asarray(jy, np.float32).any(-1) == 0
    assert jzero.sum() > 0
    np.testing.assert_array_equal(ty.float().numpy().any(-1) == 0, jzero)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_aux_loss_of_shared_logits():
    """The aux loss E * sum(mean gate * assignment share) from the same
    router weights and input, at rows 1 and 3."""
    t, d, e, f, k = 96, 32, 8, 16, 3
    ws = _weights(t, d, e, f, 0, seed=4)
    pairs = [_bf16(a) for a in ws]
    for rows in (1, 3):
        _, jaux = jmoe.moe_ffn(*[p[0] for p in pairs], top_k=k, rows=rows)
        _, taux = tmoe.moe_ffn(*[p[1] for p in pairs], top_k=k, rows=rows)
        assert taux.dtype == torch.float32 and taux.dim() == 0
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)


def test_moe_capacity_matches_reference():
    for n in (1, 2, 6, 100, 2048, 12_345, 1 << 20):
        for e, k, cf in ((64, 6, 1.25), (384, 8, 1.25), (8, 2, 8.0),
                         (4, 1, 0.5)):
            assert tmoe.moe_capacity(n, e, k, cf) == jmoe.moe_capacity(
                n, e, k, cf), (n, e, k, cf)
