"""The port's RACE hash index against the JAX reference (CPU): the uint32
bucket hash over the whole int32 range, ``locate``, ``_reserve``, ``apply``
and ``populate`` — results, bill, overflow, ``slot_keys`` and the engine
state, bit for bit — on duplicate-heavy batches and near-full and
overflowing tables, in every mode; and the typed SCAN rejection."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.oracle import OracleStore  # noqa: E402
from repro.core.types import OpKind, SyncMode  # noqa: E402
from repro.core.types import UnsupportedOpError as JUnsupported  # noqa: E402
from repro.stores import RaceHash as JRaceHash  # noqa: E402
from repro.stores import race_hash as jrh  # noqa: E402
from repro_torch.core.types import SyncMode as TSyncMode  # noqa: E402
from repro_torch.core.types import UnsupportedOpError  # noqa: E402
from repro_torch.stores import RaceHash as TRaceHash  # noqa: E402
from repro_torch.stores import race_hash as trh  # noqa: E402
from test_torch_runner import assert_fields_equal  # noqa: E402

KINDS = [OpKind.SEARCH, OpKind.INSERT, OpKind.UPDATE, OpKind.DELETE]


def _pair(capacity, mode=SyncMode.CIDER, ways=8, **kw):
    return (JRaceHash.create(capacity, mode=mode, ways=ways, **kw),
            TRaceHash.create(capacity, mode=TSyncMode(int(mode)), ways=ways,
                             device="cpu", **kw))


def _same_store(j, t):
    assert (j.n_buckets, j.ways) == (t.n_buckets, t.ways)
    assert np.array_equal(np.asarray(j.slot_keys), t.slot_keys.numpy())
    assert_fields_equal(j.state, t.state, "state")
    assert_fields_equal(j.credits, t.credits, "credits")


def _apply_both(j, t, kinds, keys, values, n_cns=1):
    j, jres, jio, jovf = j.apply(kinds, keys, values, n_cns=n_cns)
    t, tres, tio, tovf = t.apply(kinds, keys, values, n_cns=n_cns)
    assert_fields_equal(jres, tres, "results")
    assert_fields_equal(jio, tio, "io")
    assert np.array_equal(np.asarray(jovf), tovf.numpy())
    _same_store(j, t)
    return j, t, tres, tovf


def test_bucket_hash_over_the_int32_range():
    keys = np.random.default_rng(0).integers(-2**31, 2**31, 1 << 16)
    keys[:6] = (-2**31, -1, 0, 1, 2**31 - 1, 12345)
    keys = keys.astype(np.int32)
    for seed in (0x9E3779B1, 0x85EBCA77):
        for n_buckets in (2, 7, 1024, 2**19, 2**31 - 1):
            want = np.asarray(jrh._h(jnp.asarray(keys), seed, n_buckets))
            got = trh._h(torch.as_tensor(keys), seed, n_buckets).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_mixed_batches_match_reference(mode):
    """Four batches of mixed ops over a dense key space (absent keys,
    same-key INSERT runs, DELETE and INSERT of one key in one batch) on 8
    CNs: results, bill, overflow, index and store bit for bit."""
    rng = np.random.default_rng(int(mode))
    j, t = _pair(1024, mode)
    for _ in range(4):
        kinds = rng.choice(KINDS, 256, p=(0.3, 0.25, 0.3, 0.15)).astype(
            np.int32)
        keys = rng.integers(0, 600, 256).astype(np.int32)
        values = rng.integers(0, 10_000, 256).astype(np.int32)
        j, t, _, _ = _apply_both(j, t, kinds, keys, values, n_cns=8)


def test_sparse_batches_match_the_oracle():
    """The reference's own oracle contract (``tests/test_stores.py``: seed
    0, keys from 5,000, no overflow at this load), through the port."""
    rng = np.random.default_rng(0)
    t = TRaceHash.create(1024, mode=TSyncMode.CIDER, device="cpu")
    oracle = OracleStore()
    for _ in range(4):
        kinds = rng.choice(KINDS, 256, p=(0.3, 0.25, 0.3, 0.15)).astype(
            np.int32)
        keys = rng.integers(0, 5_000, 256).astype(np.int32)
        values = rng.integers(0, 10_000, 256).astype(np.int32)
        t, res, _, ovf = t.apply(kinds, keys, values, n_cns=8)
        assert not bool(ovf.any())
        ok, val = oracle.apply(kinds, keys, values)
        assert np.array_equal(res.ok.numpy(), ok)
        assert np.array_equal(res.value.numpy(), val)


def test_delete_then_insert_in_one_batch_leaks_the_slot_as_in_the_reference():
    """A reference fault the port keeps (ROADMAP, "Reference faults"): in
    one batch, INSERT k / DELETE k / INSERT k leaves k in the engine slot
    but frees the slot in the index (``apply`` clears the DELETEs' slots
    after binding the INSERTs'), so k is lost and a later INSERT reserved
    onto that slot fails.  Both packages do exactly this."""
    j, t = _pair(256, SyncMode.CIDER, ways=4)
    kinds = np.full(128, OpKind.NOP, np.int32)
    keys = np.zeros(128, np.int32)
    kinds[:3] = (OpKind.INSERT, OpKind.DELETE, OpKind.INSERT)
    keys[:3] = 77
    j, t, res, _ = _apply_both(j, t, kinds, keys, np.arange(128, dtype=np.int32))
    assert res.ok.numpy()[:3].all()
    kinds[:3] = (OpKind.SEARCH, OpKind.NOP, OpKind.NOP)
    j, t, res, _ = _apply_both(j, t, kinds, keys, np.arange(128, dtype=np.int32))
    assert not res.ok.numpy()[0]        # the oracle would find 77


@pytest.mark.parametrize("ways", [2, 4])
def test_duplicate_heavy_inserts_on_a_near_full_table(ways):
    """Batches of INSERTs drawn from few keys into a table that fills up and
    overflows: the reservation ranks, duplicate binding and overflow mask
    equal the reference's, and so does ``locate`` afterwards."""
    rng = np.random.default_rng(ways)
    j, t = _pair(256, SyncMode.MCS, ways=ways)
    for step in range(4):
        kinds = np.where(rng.random(128) < 0.8, OpKind.INSERT,
                         rng.choice(KINDS, 128)).astype(np.int32)
        keys = rng.integers(0, 100 + 80 * step, 128).astype(np.int32)
        values = rng.integers(1, 99, 128).astype(np.int32)
        j, t, _, ovf = _apply_both(j, t, kinds, keys, values, n_cns=4)
    assert bool(ovf.any())
    probe = np.arange(-64, 448, dtype=np.int32)
    for a, b in zip(j.locate(jnp.asarray(probe)), t.locate(probe)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int((t.slot_keys != -1).sum()) > 0.7 * t.slot_keys.numel()


def test_reserve_matches_reference():
    j, t = _pair(256, ways=4)
    pop = np.arange(0, 480, 3)
    j = j.populate(pop, pop + 1, chunk=128)
    t = t.populate(pop, pop + 1, chunk=128)
    _same_store(j, t)
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 600, 128).astype(np.int32)
    mask = rng.random(128) < 0.6
    a = j._reserve(jnp.asarray(keys), jnp.asarray(mask))
    b = t._reserve(torch.as_tensor(keys), torch.as_tensor(mask))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_overflow_then_delete_then_insert_matches_reference():
    j, t = _pair(256, ways=4)
    keys = (np.arange(128, dtype=np.int64) * 2654435761 % (1 << 20)).astype(
        np.int32)
    ins = np.full(128, OpKind.INSERT, np.int32)
    for step in range(3):
        j, t, res, ovf = _apply_both(j, t, ins, keys + step,
                                     np.arange(128, dtype=np.int32))
    keys = keys + 2
    ok = res.ok.numpy()
    assert ovf.numpy().any() and ok.any()
    # delete the last batch's keys, then retry the overflowed ones
    dels = np.where(ok, OpKind.DELETE, OpKind.NOP).astype(np.int32)
    j, t, res, _ = _apply_both(j, t, dels, keys, np.zeros(128, np.int32))
    assert res.ok.numpy()[ok].all()
    retry = np.where(ovf.numpy(), OpKind.INSERT, OpKind.NOP).astype(np.int32)
    j, t, res, _ = _apply_both(j, t, retry, keys, np.arange(128, dtype=np.int32))
    assert res.ok.numpy().any()


def test_populate_matches_reference():
    rng = np.random.default_rng(3)
    keys = rng.choice(100_000, size=600, replace=False)
    vals = rng.integers(0, 10_000, 600)
    j = JRaceHash.create(1024).populate(keys, vals, chunk=256)
    t = TRaceHash.create(1024, device="cpu").populate(keys, vals, chunk=256)
    _same_store(j, t)
    for a, b in zip(j.locate(jnp.asarray(keys, jnp.int32)), t.locate(keys)):
        assert np.array_equal(np.asarray(a), b.numpy())
    search = np.full(256, OpKind.SEARCH, np.int32)
    _, _, res, _ = _apply_both(j, t, search, keys[:256], vals[:256])
    ok = res.ok.numpy()
    assert ok.mean() > 0.9
    assert np.array_equal(res.value.numpy()[ok], vals[:256][ok])


def test_scan_is_rejected_with_the_typed_error():
    j, t = _pair(256)
    kinds = np.array([OpKind.SEARCH, OpKind.SCAN], np.int32)
    with pytest.raises(JUnsupported):
        j.apply(kinds, np.array([1, 2]), np.array([0, 4]))
    with pytest.raises(UnsupportedOpError, match="SmartART"):
        t.apply(kinds, np.array([1, 2]), np.array([0, 4]))
    assert issubclass(UnsupportedOpError, NotImplementedError)
    # a rejected batch leaves the store as it was
    _same_store(j, t)
