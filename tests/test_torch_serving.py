"""The port's serving path on the CPU against the JAX reference: the
CIDER-managed prefix-cache page table (results and verb bills bit for
bit), the scheduler (stats and page assignment), and the serve loop
(``--smoke --device cpu``) against the same loop driven with the JAX
``Model`` on the same weights, and the serve of every other decoder
family.  Also pins the full-config stats that ``chip_smoke.py`` checks on
the GPU (phase 6's ``qwen3-0.6b`` and phase 14's other families)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.types import SyncMode as JSyncMode  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving.pagetable import PageTable as JPageTable  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.types import SyncMode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.pagetable import PageTable  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# what the reference serve prints for its default stream (16 requests,
# 4 slots, prompt 32 with a 16-token shared prefix, 8 new tokens); the
# stats depend only on the prompts and max_new, so the smoke and the full
# qwen3-0.6b configurations give the same
SERVE_STATS = {"prefix_hits": 15, "prefix_misses": 17, "admitted": 16,
               "completed": 16}


def _drive(sched, reqs):
    """Run a scheduler over ``reqs`` with a dummy token per step; returns
    the decode steps taken."""
    for r in reqs:
        sched.submit(r)
    steps = 0
    while sched.queue or sched.active():
        sched.step_admit()
        for slot, _ in sched.active():
            sched.complete_token(slot, 0)
            steps += 1
    return steps


def _j_requests(reqs):
    return [JRequest(rid=r.rid, tokens=r.tokens, max_new=r.max_new)
            for r in reqs]


@pytest.mark.parametrize("mode", ["CIDER", "MCS"])
def test_pagetable_matches_reference(mode):
    """SEARCH misses, hot INSERTs from several CNs (write-combined under
    CIDER), SEARCH hits, DELETEs: page ids, hit masks, ok masks and every
    verb counter equal the reference's."""
    jt = JPageTable.create(n_slots=4096, mode=JSyncMode[mode])
    tt = PageTable.create(n_slots=4096, mode=SyncMode[mode], device="cpu")
    rng = np.random.default_rng(7)
    prompts = [np.concatenate([np.arange(16), rng.integers(0, 500, 32)])
               for _ in range(6)]
    keys = [jt.block_keys(p) for p in prompts]
    for p, k in zip(prompts, keys):
        assert np.array_equal(k, tt.block_keys(p))
    hot = np.concatenate(keys)                    # shared block repeated
    pages = np.arange(len(hot), dtype=np.int32)
    steps = [("lookup", (hot,)), ("publish", (hot, pages, 4)),
             ("lookup", (hot,)), ("evict", (keys[0],)),
             ("lookup", (hot,)), ("publish", (keys[1], pages[:3] + 100, 1))]
    for name, args in steps:
        jout = getattr(jt, name)(*args)
        tout = getattr(tt, name)(*args)
        for a, b in zip(jout[:-1], tout[:-1]):
            assert np.array_equal(np.asarray(a), b), name
        assert jout[-1].as_dict() == tout[-1].as_dict(), name


def test_scheduler_matches_reference():
    cfg = get_config("qwen3-0.6b", smoke=True)
    reqs = tserve.make_requests(cfg.vocab, 16, 32, 16, 8)
    jreqs = _j_requests(reqs)
    js = JScheduler(n_slots=4, n_pages=1024, page_size=16)
    ts = Scheduler(n_slots=4, n_pages=1024, page_size=16, device="cpu")
    assert _drive(js, jreqs) == _drive(ts, reqs) == 16 * 8
    assert js.stats == ts.stats == SERVE_STATS
    for a, b in zip(jreqs, reqs):
        assert (a.pages, a.cached_blocks, a.pos) == (b.pages, b.cached_blocks,
                                                     b.pos)
    assert js.free_pages == ts.free_pages


def test_full_config_stats_are_pinned():
    """The full ``qwen3-0.6b`` vocabulary draws other prompts; the
    reference's scheduler gives these stats, which ``chip_smoke.py`` holds
    the GPU serve to."""
    vocab = j_get_config("qwen3-0.6b").vocab
    assert get_config("qwen3-0.6b").vocab == vocab == 151936
    reqs = tserve.make_requests(vocab, 16, 32, 16, 8)
    js = JScheduler(n_slots=4, n_pages=1024, page_size=16)
    ts = Scheduler(n_slots=4, n_pages=1024, page_size=16, device="cpu")
    _drive(js, _j_requests(reqs))
    _drive(ts, tserve.make_requests(vocab, 16, 32, 16, 8))
    assert js.stats == ts.stats == SERVE_STATS
    assert _chip_smoke().SERVE_STATS == SERVE_STATS


def test_serve_main_smoke_on_cpu_gives_reference_stats(capsys):
    stats = tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu"])
    assert stats == SERVE_STATS
    assert "served 16 requests" in capsys.readouterr().out


def _jax_serve(jm, jp, reqs, smax):
    """``repro.launch.serve``'s loop (serve.py:52-76), recording each
    request's tokens and the logits each token was chosen from."""
    sched = JScheduler(n_slots=4, n_pages=1024, page_size=16)
    for r in reqs:
        sched.submit(r)
    decode = jax.jit(jm.decode_step)
    states, outs, logits_seen = {}, {}, {}
    while sched.queue or sched.active():
        sched.step_admit()
        for slot, req in sched.active():
            if slot not in states or states[slot][0] is not req:
                st = jm.init_decode_state(1, smax=smax)
                tok = jnp.asarray(req.tokens[None, :], jnp.int32)
                for t in range(req.tokens.shape[0]):
                    logits, st = decode(jp, st, tok[:, t:t + 1], jnp.int32(t))
                states[slot] = (req, st, logits)
            req, st, logits = states[slot]
            row = np.asarray(logits[0, -1], np.float32)
            logits_seen.setdefault(req.rid, []).append(row)
            nxt = int(row.argmax())
            sched.complete_token(slot, nxt)
            if not req.done:
                logits, st = decode(jp, st, jnp.asarray([[nxt]], jnp.int32),
                                    jnp.int32(req.pos - 1))
                states[slot] = (req, st, logits)
            else:
                states.pop(slot, None)
                outs[req.rid] = list(req.out)
    return outs, logits_seen, sched.stats


def test_serve_greedy_tokens_match_jax_loop():
    """The port's serve loop and the reference's, on the reference's
    weights: every request's greedy tokens are equal up to the first token
    where the reference's own logits for the two choices lie within the
    model tolerance (a bf16 near-tie that one-ulp rounding differences
    between XLA and PyTorch may break either way; after it the two
    continuations differ by design).  Most requests match in full."""
    jm = JModel(j_get_config("qwen3-0.6b", smoke=True))
    jp = unbox(jm.init(jax.random.key(0)))
    tm = Model(get_config("qwen3-0.6b", smoke=True), device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    reqs = tserve.make_requests(tm.cfg.vocab, 16, 32, 16, 8)
    jouts, jlogits, jstats = _jax_serve(jm, jp, _j_requests(reqs), 40)
    sched = Scheduler(n_slots=4, n_pages=1024, page_size=16, device="cpu")
    for r in reqs:
        sched.submit(r)
    touts = tserve.serve(tm, tp, sched, 40)
    assert jstats == sched.stats == SERVE_STATS
    assert sorted(jouts) == sorted(touts) == list(range(16))
    full = 0
    for rid in jouts:
        a, b = jouts[rid], touts[rid]
        assert len(a) == len(b) == 8
        first = next((i for i in range(8) if a[i] != b[i]), None)
        if first is None:
            full += 1
            continue
        row = jlogits[rid][first]
        gap = row[a[first]] - row[b[first]]
        assert 0 <= gap <= 6.25e-2, (rid, first, a, b, gap)
    assert full >= 12, f"only {full} of 16 requests match in full"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "phi-3-vision-4.2b",
                                  "kimi-k2-1t-a32b"])
def test_other_family_serve_stats_are_pinned(arch):
    """Each decoder family that ``chip_smoke.py`` phase 14 serves at full
    width: the reference's scheduler over that vocabulary's default
    stream (16 requests) gives the stats the script holds the GPU serve
    to."""
    smoke = _chip_smoke()
    n = 16
    vocab = j_get_config(arch).vocab
    assert get_config(arch).vocab == vocab
    js = JScheduler(n_slots=4, n_pages=1024, page_size=16)
    ts = Scheduler(n_slots=4, n_pages=1024, page_size=16, device="cpu")
    assert _drive(js, _j_requests(tserve.make_requests(vocab, n, 32, 16, 8))) \
        == _drive(ts, tserve.make_requests(vocab, n, 32, 16, 8))
    assert js.stats == ts.stats == smoke.SERVE_STATS_14[arch]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "phi-3-vision-4.2b"])
def test_serve_main_other_families_on_cpu(arch, capsys):
    """``serve.main`` for every decoder family at its smoke config on the
    CPU: the stats of the reference's scheduler over the same 4 requests."""
    cfg = get_config(arch, smoke=True)
    js = JScheduler(n_slots=4, n_pages=1024, page_size=16)
    _drive(js, _j_requests(tserve.make_requests(cfg.vocab, 4, 32, 16, 4)))
    stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "4", "--max-new", "4"])
    assert stats == js.stats
    assert "served 4 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch,layers", [("qwen3-0.6b", 1),
                                         ("recurrentgemma-9b", 3),
                                         ("kimi-k2-1t-a32b", 1)])
def test_serve_main_layers_keep_the_stats(arch, layers, capsys):
    """``--layers`` cuts the depth (as ``chip_smoke.py`` phase 14 serves
    at 2 layers, the hybrid 6, kimi-k2-1t-a32b 1): the stats depend on the
    request stream alone, so they stay the reference scheduler's."""
    cfg = get_config(arch, smoke=True)
    js = JScheduler(n_slots=4, n_pages=1024, page_size=16)
    _drive(js, _j_requests(tserve.make_requests(cfg.vocab, 4, 32, 16, 4)))
    stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "4", "--max-new", "4", "--layers",
                         str(layers)])
    assert stats == js.stats
    assert layers < cfg.n_layers
    capsys.readouterr()


def test_serve_main_refuses_the_encoder():
    """hubert-xlarge has no decode step: the serve raises as the
    reference's ``init_decode_state`` does."""
    with pytest.raises(ValueError, match="has no decode state"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
