"""``repro_torch.core.engine.apply_batch`` against the JAX reference, window
by window: the full ``Results``, ``IOMetrics``, ``StoreState`` and
``CreditState`` must be bit-equal for all four SyncModes, with and without
SCAN probes (``scan_max`` 0 and 8), across a CN crash (step 5b) and under
replication (step 5d).  Inputs are seeded numpy arrays given to both."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.credits import credit_init as j_credit_init  # noqa: E402
from repro.core.types import EngineConfig as JConfig  # noqa: E402
from repro.core.types import OpBatch as JBatch  # noqa: E402
from repro.core.types import SyncMode  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.credits import credit_init as t_credit_init  # noqa: E402
from repro_torch.core.types import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.types import OpBatch as TBatch  # noqa: E402

N_SLOTS, B, N_CNS, WINDOWS, TABLE = 96, 128, 4, 4, 64


def assert_fields_equal(ref, port, what):
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(port, f.name).numpy()
        assert a.dtype == b.dtype, (what, f.name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f.name, a, b)


def windows(seed: int, scan: bool):
    """Seeded windows with a hot key written from every CN (so CIDER's
    credit plane warms up) and a mix of every op kind."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(WINDOWS):
        kinds = rng.choice(6 if scan else 5, B,
                           p=([.2, .1, .45, .1, .0, .15] if scan
                              else [.25, .1, .5, .1, .05])).astype(np.int32)
        keys = rng.integers(0, N_SLOTS, B).astype(np.int32)
        keys[::5] = 7                      # hot key across CNs
        kinds[::5] = 2
        values = rng.integers(1, 1000, B).astype(np.int32)
        values = np.where(kinds == 5, rng.integers(0, 12, B), values)
        out.append((kinds, keys, values.astype(np.int32)))
    return out


def run_both(mode, scan_max, variant, seed=0, backend="jnp"):
    kw = dict(n_slots=N_SLOTS, heap_slots=N_SLOTS + WINDOWS * B // 2,
              mode=mode, scan_max=scan_max)
    if variant == "replicas":
        kw["n_replicas"] = 2
    if variant == "no_local_wc":
        kw["local_wc"] = False
    jcfg = JConfig(**kw, kernel_backend=backend)
    tcfg = TConfig(**kw)
    pk = np.arange(0, N_SLOTS, 3)
    js = jeng.populate(jcfg, jeng.store_init(jcfg), pk, pk + 1000)
    ts = teng.populate(tcfg, teng.store_init(tcfg, "cpu"), pk, pk + 1000)
    jc, tc = j_credit_init(TABLE), t_credit_init(TABLE, "cpu")
    alive = np.ones(N_CNS, bool)
    repairs = 0
    for w, (kinds, keys, values) in enumerate(windows(seed, scan_max > 0)):
        jb = JBatch.make(kinds, keys, values, n_cns=N_CNS)
        tb = TBatch.make(kinds, keys, values, n_cns=N_CNS, device="cpu")
        valid = np.random.default_rng(seed + w).random(B) < 0.95
        liv = {}
        if variant in ("crash", "replicas"):
            now = alive.copy()
            if variant == "crash" and w == 2:
                now[1] = False             # CN 1 dies at window 2
            died = alive & ~now
            alive = now
            liv = dict(alive=now, died=died)
        js, jc, jr, jio = jeng.apply_batch(
            jcfg, js, jc, jb, valid=jnp.asarray(valid),
            **{k: jnp.asarray(v) for k, v in liv.items()})
        ts, tc, tr, tio = teng.apply_batch(
            tcfg, ts, tc, tb, valid=torch.as_tensor(valid),
            **{k: torch.as_tensor(v) for k, v in liv.items()})
        what = f"{mode.name}/scan{scan_max}/{variant}/w{w}"
        assert_fields_equal(jr, tr, what + "/results")
        assert_fields_equal(jio, tio, what + "/io")
        assert_fields_equal(js, ts, what + "/state")
        assert_fields_equal(jc, tc, what + "/credits")
        repairs += int(tio.repair_cas) + int(tio.orphan_windows)
    return repairs


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
@pytest.mark.parametrize("scan_max", [0, 8])
@pytest.mark.parametrize("variant", ["plain", "crash"])
def test_apply_batch_matches_reference(mode, scan_max, variant):
    repairs = run_both(mode, scan_max, variant)
    # the crash strands locks in every locking mode; OSYNC strands nothing
    assert (repairs > 0) == (variant == "crash" and mode != SyncMode.OSYNC)


def test_store_helpers_match_reference():
    cfg_kw = dict(n_slots=32, heap_slots=40)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    keys = np.array([3, 9, 30, 4], np.int32)
    vals = np.array([11, 12, 13, 14], np.int32)
    js = jeng.populate(jcfg, jeng.store_init(jcfg), keys, vals)
    ts = teng.populate(tcfg, teng.store_init(tcfg, "cpu"), keys, vals)
    assert_fields_equal(js, ts, "populate")
    for a, b in zip(jeng.store_view(js), teng.store_view(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())
    ver = np.arange(32, dtype=np.int32) % 16
    strand = np.arange(32, dtype=np.int32) * 3
    assert np.array_equal(
        np.asarray(jeng.pack_meta(jnp.asarray(ver), jnp.asarray(strand))),
        teng.pack_meta(torch.as_tensor(ver), torch.as_tensor(strand)).numpy())
    with pytest.raises(ValueError, match="heap_slots"):
        teng.populate(tcfg, ts, np.arange(41), np.arange(41))


def test_backoff_polls_matches_reference():
    w = np.arange(0, 2**20 + 1, dtype=np.int32)
    for cap in (0, 1, 6, 13, 20, 21):
        want = np.asarray(jeng._backoff_polls(jnp.asarray(w), cap))
        got = teng._backoff_polls(torch.as_tensor(w), cap).numpy()
        assert np.array_equal(want, got), cap


def test_heap_overflow_commits_are_dropped_like_the_reference():
    """A heap too small for the window's commits: the reference drops the
    out-of-range heap writes and still swings the pointers."""
    kw = dict(n_slots=16, heap_slots=18, mode=SyncMode.CIDER)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    keys = np.arange(16, dtype=np.int32)
    js = jeng.populate(jcfg, jeng.store_init(jcfg), keys, keys)
    ts = teng.populate(tcfg, teng.store_init(tcfg, "cpu"), keys, keys)
    jc, tc = j_credit_init(8), t_credit_init(8, "cpu")
    kinds = np.full(16, 2, np.int32)
    for w in range(2):
        vals = keys + 100 * (w + 1)
        js, jc, jr, jio = jeng.apply_batch(jcfg, js, jc,
                                           JBatch.make(kinds, keys, vals))
        ts, tc, tr, tio = teng.apply_batch(tcfg, ts, tc,
                                           TBatch.make(kinds, keys, vals,
                                                       device="cpu"))
        assert_fields_equal(js, ts, f"overflow w{w}")
        assert_fields_equal(jr, tr, f"overflow w{w}")
    for a, b in zip(jeng.store_view(js), teng.store_view(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())
