"""The port's kernel modules against the JAX package's kernels.

On the CPU the engine's seams run each kernel's plain PyTorch version;
these tests hold it
bit for bit to the Pallas kernel (``interpret=True``, as
``tests/test_kernels.py`` runs it) and to the reference's jnp oracle, on the
same seeded numpy inputs.  The kernels themselves are held to the plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.scan_probe.ops import scan_probe_op  # noqa: E402
from repro.kernels.scan_probe.ref import scan_probe_ref as jax_scan_probe_ref  # noqa: E402
from repro.kernels.wc_combine.ops import wc_combine_op  # noqa: E402
from repro.kernels.wc_combine.ref import wc_combine_ref as jax_wc_combine_ref  # noqa: E402
from repro_torch.core.combine import _first_last_rank, resolve_backend  # noqa: E402
from repro_torch.core.engine import _probe_sweep  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.scan_probe import ops as sp  # noqa: E402
from repro_torch.kernels.wc_combine import ops as wcc  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:  # pragma: no cover
    HAVE_HYP = False

BIG = 2**31 - 1


def sorted_keys(layout: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if layout == "distinct":
        return np.arange(n, dtype=np.int32) * 5 - 7
    if layout == "giant_run":
        return np.full(n, 42, np.int32)
    if layout == "all_invalid":
        return np.full(n, BIG, np.int32)
    if layout == "sentinel_tail":
        k = np.sort(rng.integers(-50, 50, n)).astype(np.int32)
        k[n - n // 3:] = BIG
        return k
    return np.sort(rng.integers(0, max(n // 6, 1), n)).astype(np.int32)


def probe_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed + 1)
    return (rng.integers(-1, 2, n).astype(np.int32), rng.random(n) < 0.3,
            rng.random(n) < 0.5)


def assert_same(port_outs, jax_outs, what):
    for i, (p, j) in enumerate(zip(port_outs, jax_outs)):
        a, b = p.numpy(), np.asarray(j)
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, i, np.nonzero(a != b)[0][:8])


LAYOUTS = ["distinct", "giant_run", "all_invalid", "sentinel_tail", "dup_heavy"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 7, 300, 1000])
def test_wc_combine_plain_matches_pallas_and_jnp(layout, n):
    k = sorted_keys(layout, n, seed=n)
    before = wcc.counter.count
    port = _first_last_rank(torch.as_tensor(k), "auto")  # CPU: plain version
    assert wcc.counter.count == before                     # no kernel launched
    assert_same(port, wc_combine_op(jnp.asarray(k), block=256, interpret=True),
                f"pallas {layout} {n}")
    assert_same(port, jax_wc_combine_ref(jnp.asarray(k)), f"jnp {layout} {n}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 7, 300, 1000])
def test_scan_probe_plain_matches_pallas_and_jnp(layout, n):
    k = sorted_keys(layout, n, seed=n + 11)
    sc, wr, ei = probe_inputs(n, seed=n)
    before = sp.counter.count
    port = _probe_sweep(*(torch.as_tensor(x) for x in (k, sc, wr, ei)), "auto")
    assert sp.counter.count == before
    jargs = [jnp.asarray(x) for x in (k, sc, wr, ei)]
    assert_same(port, scan_probe_op(*jargs, block=256, interpret=True),
                f"pallas {layout} {n}")
    assert_same(port, jax_scan_probe_ref(*jargs), f"jnp {layout} {n}")


if HAVE_HYP:
    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.integers(-3, 3), min_size=1, max_size=200),
           st.integers(0, 2**31 - 1))
    def test_wc_combine_property(vals, seed):
        k = np.sort(np.asarray(vals, np.int32))
        port = wcc.wc_combine_ref(torch.as_tensor(k))
        assert_same(port, jax_wc_combine_ref(jnp.asarray(k)), "hyp")
        first, last, rank = (x.numpy() for x in port)
        # run structure: heads and tails pair up, ranks restart at heads
        assert first.sum() == last.sum() == len(np.unique(k))
        assert (rank[first] == 0).all()

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 4), st.integers(-1, 1),
                              st.booleans(), st.booleans()),
                    min_size=1, max_size=200))
    def test_scan_probe_property(lanes):
        lanes = sorted(lanes, key=lambda t: t[0])
        cols = [np.asarray(c) for c in zip(*lanes)]
        k, sc = cols[0].astype(np.int32), cols[1].astype(np.int32)
        wr, ei = cols[2].astype(bool), cols[3].astype(bool)
        port = sp.scan_probe_ref(*(torch.as_tensor(x) for x in (k, sc, wr, ei)))
        assert_same(port, jax_scan_probe_ref(*(jnp.asarray(x) for x in
                                               (k, sc, wr, ei))), "hyp")
        # O(n^2) oracle: walk each run from its head
        e_b, waits = (x.numpy() for x in port)
        for i in range(len(k)):
            j = i
            while j > 0 and k[j - 1] == k[i]:
                j -= 1
            setters = [c for c in sc[j:i] if c >= 0]
            assert e_b[i] == (setters[-1] == 1 if setters else ei[i])
            assert waits[i] == int(wr[j:i].sum())


def test_wrappers_refuse_cpu_tensors_for_the_kernel():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        wcc.wc_combine_cuda(k)
    with pytest.raises(ValueError, match="CUDA"):
        sp.scan_probe_cuda(k, k, k.bool(), k.bool())
    for bad in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            resolve_backend(bad, k.device)
    assert resolve_backend("auto", k.device) == "torch"
    assert resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve_backend("torch", torch.device("cuda", 0)) == "torch"


def test_build_sources_and_flags():
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f"{name}_launch" in src and "cudaGetLastError" in src
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build._target("wc_combine").name.startswith("libwc_combine-")
