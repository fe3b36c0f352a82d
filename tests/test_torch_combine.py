"""``repro_torch.core.combine`` and ``credits`` against the JAX reference,
bit for bit, on seeded numpy inputs (CPU)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import combine as jwc  # noqa: E402
from repro.core import credits as jcr  # noqa: E402
from repro_torch.core import combine as twc  # noqa: E402
from repro_torch.core import credits as tcr  # noqa: E402


def t(x):
    return torch.as_tensor(np.array(x))


def assert_fields_equal(ref, port, what=""):
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(port, f.name).numpy()
        assert a.dtype == b.dtype, (what, f.name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f.name)


def window(seed: int, b: int, n_keys: int, p_valid: float, n_cns: int = 4):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, b).astype(np.int32)
    pos = rng.permutation(b).astype(np.int32)
    valid = rng.random(b) < p_valid
    cn = rng.integers(0, n_cns, b).astype(np.int32)
    return keys, pos, valid, cn


CASES = [(0, 64, 16, 0.8), (1, 257, 4, 0.9), (2, 300, 300, 0.5),
         (3, 128, 8, 0.0), (4, 1, 1, 1.0), (5, 512, 2, 1.0)]


@pytest.mark.parametrize("seed,b,n_keys,p_valid", CASES)
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_plan_combine_and_stats(seed, b, n_keys, p_valid, backend):
    keys, pos, valid, _ = window(seed, b, n_keys, p_valid)
    jp = jwc.plan_combine(jnp.asarray(keys), jnp.asarray(pos),
                          jnp.asarray(valid), backend=backend)
    tp = twc.plan_combine(t(keys), t(pos), t(valid))
    assert_fields_equal(jp, tp, "plan")
    mask = valid & (np.random.default_rng(seed + 9).random(b) < 0.6)
    assert_fields_equal(jwc.stats_from_plan(jp, jnp.asarray(mask)),
                        twc.stats_from_plan(tp, t(mask)), "stats")
    assert_fields_equal(
        jwc.per_key_stats(jnp.asarray(keys), jnp.asarray(pos),
                          jnp.asarray(mask)),
        twc.per_key_stats(t(keys), t(pos), t(mask)), "per_key_stats")
    vals = np.arange(b, dtype=np.int32) * 7
    for a, c in zip(jwc.segment_last(jp, jnp.asarray(vals)),
                    twc.segment_last(tp, t(vals))):
        assert np.array_equal(np.asarray(a), c.numpy())
    assert np.array_equal(np.asarray(jwc.segment_counts(jp, jnp.asarray(valid))),
                          twc.segment_counts(tp, t(valid)).numpy())


@pytest.mark.parametrize("seed,b,n_keys,p_valid", CASES)
def test_groups_and_local_executors(seed, b, n_keys, p_valid):
    keys, pos, valid, cn = window(seed, b, n_keys, p_valid)
    jg = jwc.plan_groups(*(jnp.asarray(x) for x in (keys, cn, pos, valid)))
    tg = twc.plan_groups(*(t(x) for x in (keys, cn, pos, valid)))
    assert_fields_equal(jg, tg, "groups")
    mask = valid & (np.random.default_rng(seed).random(b) < 0.7)
    want = np.asarray(jwc.group_last(jg, jnp.asarray(mask)))
    assert np.array_equal(want, twc.group_last(tg, t(mask)).numpy())
    assert np.array_equal(
        np.asarray(jwc.local_executors(*(jnp.asarray(x) for x in
                                         (keys, cn, pos, mask)))),
        twc.local_executors(*(t(x) for x in (keys, cn, pos, mask))).numpy())
    # the sort-free form equals the sort form under the OpBatch contract
    # (pos unique, cn in range): against both packages
    uniq_pos = np.arange(b, dtype=np.int32)
    scat = twc.local_executors_scatter(t(keys), t(cn), t(uniq_pos), t(mask),
                                       n_keys, 4).numpy()
    assert np.array_equal(scat, np.asarray(jwc.local_executors_scatter(
        *(jnp.asarray(x) for x in (keys, cn, uniq_pos, mask)), n_keys, 4)))
    tg2 = twc.plan_groups(*(t(x) for x in (keys, cn, uniq_pos, valid)))
    assert np.array_equal(scat, twc.group_last(tg2, t(mask)).numpy())


@pytest.mark.parametrize("seed", range(4))
def test_reader_waits(seed):
    rng = np.random.default_rng(seed)
    b = 200
    keys = rng.integers(0, 10, b).astype(np.int32)
    pos = np.arange(b, dtype=np.int32)
    role = rng.integers(0, 3, b)
    readers, writers = role == 1, role == 2
    want = jwc.reader_waits(*(jnp.asarray(x) for x in
                              (keys, pos, readers, writers)))
    got = twc.reader_waits(*(t(x) for x in (keys, pos, readers, writers)))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_lexsort2_is_stable_on_ties():
    major = np.array([3, 1, 3, 1, 2, 3], np.int32)
    minor = np.array([0, 5, 0, -4, 2**31 - 1, -2**31], np.int32)
    want = np.asarray(jnp.lexsort((jnp.asarray(minor), jnp.asarray(major))))
    assert np.array_equal(twc.lexsort2(t(minor), t(major)).numpy(), want)


@pytest.mark.parametrize("table", [1024, 4096, 4093, 1])
def test_credit_slot_full_int32_range(table):
    rng = np.random.default_rng(table)
    keys = np.concatenate([
        rng.integers(-2**31, 2**31, 200_000),
        np.arange(-2**31, -2**31 + 1000), np.arange(2**31 - 1000, 2**31),
        np.arange(0, 70_000),                  # slots past a keyspace end
    ]).astype(np.int32)
    want = np.asarray(jcr.credit_slot(jnp.asarray(keys), table))
    got = tcr.credit_slot(t(keys), table)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def random_credits(seed: int, table: int):
    rng = np.random.default_rng(seed)
    credit = np.where(rng.random(table) < 0.3,
                      rng.integers(0, 80, table), 0).astype(np.int32)
    retry = rng.integers(0, 5, table).astype(np.int32)
    return credit, retry


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("initial_credit,aimd", [(36, 2), (10, 3)])
def test_credit_decide_and_feedback(seed, initial_credit, aimd):
    table, b = 64, 300
    credit, retry = random_credits(seed, table)
    rng = np.random.default_rng(seed + 100)
    keys = rng.integers(0, 500, b).astype(np.int32)
    is_write = rng.random(b) < 0.6
    js = jcr.CreditState(jnp.asarray(credit), jnp.asarray(retry))
    ts = tcr.CreditState(t(credit), t(retry))
    js2, jpess = jcr.credit_decide(js, jnp.asarray(keys),
                                   jnp.asarray(is_write), table)
    ts2, tpess = tcr.credit_decide(ts, t(keys), t(is_write), table)
    assert_fields_equal(js2, ts2, "decide")
    assert np.array_equal(np.asarray(jpess), tpess.numpy())
    pess = np.asarray(jpess)
    wc_batch = rng.integers(1, 4, b).astype(np.int32)
    opt = ~pess & (rng.random(b) < 0.7)
    n_retry = rng.integers(0, 5, b).astype(np.int32)
    kw = dict(initial_credit=initial_credit, hotness_threshold=2,
              aimd_factor=aimd)
    want = jcr.credit_feedback(js2, jnp.asarray(keys), table, jnp.asarray(pess),
                               jnp.asarray(wc_batch), jnp.asarray(opt),
                               jnp.asarray(n_retry), **kw)
    got = tcr.credit_feedback(ts2, t(keys), table, t(pess), t(wc_batch),
                              t(opt), t(n_retry), **kw)
    assert_fields_equal(want, got, "feedback")


def test_odd_initial_credit_promotes_nothing_on_untouched_slots():
    """The port's intended semantics for an odd ``initial_credit``: a slot
    no lane touched keeps its credit.  The reference fills such slots'
    ``segment_max`` with INT32_MIN and wraps them to -2**31 (a logged
    reference fault); the touched slots agree."""
    table = 16
    credit = np.arange(table, dtype=np.int32)
    retry = np.full(table, 3, np.int32)
    keys = np.array([1, 1, 2], np.int32)
    slots = tcr.credit_slot(t(keys), table).numpy()
    untouched = np.setdiff1d(np.arange(table), slots)
    z = np.zeros(3, np.int32)
    opt = np.array([True, True, True])
    n_retry = np.array([3, 4, 0], np.int32)
    kw = dict(initial_credit=35, hotness_threshold=2, aimd_factor=2)
    got = tcr.credit_feedback(tcr.CreditState(t(credit), t(retry)), t(keys),
                              table, t(z.astype(bool)), t(z), t(opt),
                              t(n_retry), **kw)
    c = got.credit.numpy()
    assert np.array_equal(c[untouched], credit[untouched])
    assert c[slots[0]] == credit[slots[0]] + 35        # hot twice: promoted
    ref = jcr.credit_feedback(
        jcr.CreditState(jnp.asarray(credit), jnp.asarray(retry)),
        jnp.asarray(keys), table, jnp.asarray(z.astype(bool)), jnp.asarray(z),
        jnp.asarray(opt), jnp.asarray(n_retry), **kw)
    rc = np.asarray(ref.credit)
    assert np.array_equal(rc[slots], c[slots])
    assert (rc[untouched] == credit[untouched] + np.int32(-2**31)).all()  # fault
    # an even value agrees everywhere
    kw["initial_credit"] = 36
    got = tcr.credit_feedback(tcr.CreditState(t(credit), t(retry)), t(keys),
                              table, t(z.astype(bool)), t(z), t(opt),
                              t(n_retry), **kw)
    ref = jcr.credit_feedback(
        jcr.CreditState(jnp.asarray(credit), jnp.asarray(retry)),
        jnp.asarray(keys), table, jnp.asarray(z.astype(bool)), jnp.asarray(z),
        jnp.asarray(opt), jnp.asarray(n_retry), **kw)
    assert np.array_equal(np.asarray(ref.credit), got.credit.numpy())
