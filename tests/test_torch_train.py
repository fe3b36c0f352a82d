"""The port's training slice on the CPU against the JAX reference, at the
``qwen3-0.6b`` smoke config: ``cross_entropy``; ``Model.loss_fn`` and its
gradients against ``jax.value_and_grad(model.loss_fn)`` with the
reference's initial weights carried over by ``interop``; ``remat="block"``
against no remat; ``adamw_update`` and ``clip_by_global_norm`` on one
state carried both ways (``interop.opt_state_{from,to}_numpy``);
``ef_compress_tree``; ``FleetMonitor`` through the reference's own
``tests/test_ft.py``; ``Pipeline.batch_at``; ``launch.train.main`` for 3
steps against the reference's ``main`` on the same weights and batches;
and a checkpoint restart.

Tolerances: the loss within rtol 2e-3, each gradient leaf within
``|g_port - g_ref| / |g_ref|`` <= 2e-2 (norms over the leaf).  Both run
bf16 weights and activations, which XLA and PyTorch round at different
places (``tests/test_torch_models.py``); a bf16 ulp is 2^-8 relative, and
the backward's sums over 64 tokens carry a few of them.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.dist.compress import ef_compress_tree as j_compress  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import cross_entropy as j_ce  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
import repro_torch.launch.train as ttrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, Pipeline  # noqa: E402
from repro_torch.dist.compress import (ef_compress_tree,  # noqa: E402
                                       ef_decompress_tree, zeros_residuals)
from repro_torch.ft import failures as tft  # noqa: E402
from repro_torch.models.model import Model, cross_entropy  # noqa: E402
from repro_torch.train.optimizer import (adamw_init,  # noqa: E402
                                         adamw_update, clip_by_global_norm,
                                         tree_leaves, tree_map)
from repro_torch.workloads.zipf import scramble32  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b"
B, S = 2, 64
LOSS_RTOL, GRAD_REL = 2e-3, 2e-2


def _j_params(arch=ARCH):
    jm = JModel(j_get_config(arch, smoke=True))
    return jm, unbox(jm.init(jax.random.key(0)))


def _t_params(jp):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab, b=B, s=S, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)
                                                ).astype(np.int32)


def _port_value_and_grad(model, params, batch):
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params),
                                materialize_grads=True)
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


def _rel(got: torch.Tensor, want) -> float:
    g = got.to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def check_grads(got: dict, want: dict, what: str, bound=GRAD_REL) -> None:
    """Every leaf of ``got`` within ``bound`` relative (by norm) of the
    reference's; names the first leaf that is not."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(tree_leaves(got)), what
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        name = "/".join(str(p.key) for p in path)
        assert tuple(g.shape) == w.shape, f"{what} {name}"
        assert g.dtype == interop.params_from_numpy(
            {"x": np.zeros((), w.dtype)}, "cpu")["x"].dtype, f"{what} {name}"
        rel = _rel(g, w)
        assert rel <= bound, f"{what}: leaf {name} off by {rel:.3g}"


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 16, 40)).astype(np.float32) * 4
    tg = rng.integers(0, 40, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = j_ce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(tg),
                    None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(tg),
                            None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = np.zeros_like(mask)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(tg),
                        torch.from_numpy(zero))
    assert float(got) == float(j_ce(jnp.asarray(logits), jnp.asarray(tg),
                                    jnp.asarray(zero))) == 0.0


@pytest.fixture(scope="module")
def qwen():
    jm, jp = _j_params()
    toks = _tokens(jm.cfg.vocab)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "targets": torch.from_numpy(toks[:, 1:])}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp,
                                                                        jb)
    return jm, jp, jb, tb, jl, jg


def test_loss_and_grads_match_reference(qwen):
    jm, jp, _, tb, jl, jg = qwen
    tm = Model(get_config(ARCH, smoke=True), device="cpu")
    loss, metrics, grads = _port_value_and_grad(tm, _t_params(jp), tb)
    assert loss.dtype == torch.float32 and float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    check_grads(grads, jg, ARCH)
    for leaf in tree_leaves(grads):
        assert bool(torch.isfinite(leaf).all()) and bool(leaf.abs().sum() > 0)


def test_remat_block_gives_the_same_gradients_as_none(qwen):
    """Checkpointing recomputes each block in the backward: the same
    gradients, bit for bit on the CPU, with the block's activations not
    kept."""
    _, jp, _, tb, _, _ = qwen
    cfg = get_config(ARCH, smoke=True)
    assert cfg.remat == "block"
    outs = []
    for c in (cfg, dataclasses.replace(cfg, remat="none")):
        loss, _, grads = _port_value_and_grad(Model(c, device="cpu"),
                                              _t_params(jp), tb)
        outs.append((loss, tree_leaves(grads)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_masked_loss_matches_reference(qwen):
    jm, jp, jb, tb, _, _ = qwen
    mask = (np.random.default_rng(5).random((B, S)) < 0.5).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, dict(jb, mask=jnp.asarray(mask)))
    tm = Model(get_config(ARCH, smoke=True), device="cpu")
    loss, _, grads = _port_value_and_grad(
        tm, _t_params(jp), dict(tb, mask=torch.from_numpy(mask)))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    check_grads(grads, jg, f"{ARCH} masked")


def test_adamw_update_matches_reference(qwen):
    """One update from a state carried over from the reference (after two
    reference steps, so the moments and bias correction are not trivial),
    with the reference's gradients: parameters within one bf16 ulp, the
    moments within f32 rounding, step and gnorm equal."""
    _, jp, _, _, _, jg = qwen
    update = jax.jit(lambda p, g, o: jopt.adamw_update(p, g, o, lr=1e-2))
    jo = jopt.adamw_init(jp)
    p1, jo, _ = update(jp, jg, jo)
    p1, jo, _ = update(p1, jg, jo)
    p2, jo2, jgn = update(p1, jg, jo)
    tnp = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    topt = interop.opt_state_from_numpy(tnp(jo.m), tnp(jo.v),
                                        np.asarray(jo.step), "cpu")
    assert int(topt.step) == 2 and topt.step.dtype == torch.int32
    tp2, topt2, tgn = adamw_update(_t_params(p1), _t_params(jg), topt,
                                   lr=1e-2)
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)
    back = interop.opt_state_to_numpy(topt2)
    assert int(back["step"]) == int(jo2.step) == 3
    rebuilt = jopt.OptState(**{k: jax.tree.map(jnp.asarray, v)
                               for k, v in back.items()})
    for got, want in zip(jax.tree.leaves(rebuilt.m) + jax.tree.leaves(
            rebuilt.v), jax.tree.leaves(jo2.m) + jax.tree.leaves(jo2.v)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-12)
    got_p = interop.params_to_numpy(tp2)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(p2)[0],
            jax.tree.leaves(got_p)):
        w = np.asarray(want, np.float32)
        # one bf16 ulp (f32 rounding for the f32 norms); atol for the
        # few values that p - lr * u cancels to near 0
        ulp = 2.0 ** -7 if want.dtype == jnp.bfloat16 else 1e-6
        np.testing.assert_allclose(got, w, rtol=ulp, atol=1e-7,
                                   err_msg=str(path))


@pytest.mark.parametrize("chunk", [1, 7, 1 << 25])
def test_adamw_update_in_chunks_gives_the_whole_leaf_bits(monkeypatch,
                                                           chunk):
    """``adamw_update`` takes each leaf in chunks of ``CHUNK`` elements,
    clipping as it goes: its parameters, moments, step and norm equal bit
    for bit the whole-leaf formula (the clipped tree of
    ``clip_by_global_norm``, then one pass over each leaf), at chunks that
    cut every leaf (1, 7) or none, and its arguments are left as they
    were."""
    from repro_torch.train import optimizer as topt_mod
    rng = np.random.default_rng(3)

    def leaf(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    shapes = {"a": ((3, 5, 7), torch.bfloat16), "b": ((11,), torch.bfloat16),
              "c": ((4, 4), torch.float32), "d": ((), torch.float32)}
    params = {k: leaf(*v) for k, v in shapes.items()}
    grads = {k: leaf(*v) * 3 for k, v in shapes.items()}
    opt = topt_mod.OptState(
        m={k: leaf(v[0], torch.float32) * 0.1 for k, v in shapes.items()},
        v={k: leaf(v[0], torch.float32).square() for k, v in shapes.items()},
        step=torch.tensor(2, dtype=torch.int32))
    def args():
        return [x for t in (params, grads, opt.m, opt.v)
                for x in tree_leaves(t)]

    before = [x.clone() for x in args()]
    kw = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, wd=0.1)

    # the whole-leaf formula
    clipped, want_gn = clip_by_global_norm(grads, 0.5)
    t = torch.tensor(3.0)
    c1, c2 = 1 - torch.tensor(0.9) ** t, 1 - torch.tensor(0.95) ** t
    want = {}
    for k in shapes:
        p, g32 = params[k], clipped[k].to(torch.float32)
        m2 = 0.9 * opt.m[k] + (1 - 0.9) * g32
        v2 = 0.95 * opt.v[k] + (1 - 0.95) * g32.square()
        u = (m2 / c1) / (torch.sqrt(v2 / c2) + 1e-8) + 0.1 * p.to(
            torch.float32)
        want[k] = ((p.to(torch.float32) - 1e-2 * u).to(p.dtype), m2, v2)

    monkeypatch.setattr(topt_mod, "CHUNK", chunk)
    got_p, got_opt, got_gn = adamw_update(params, grads, opt, max_norm=0.5,
                                          **kw)
    assert torch.equal(got_gn, want_gn) and int(got_opt.step) == 3
    for k, (p2, m2, v2) in want.items():
        for got, w in ((got_p[k], p2), (got_opt.m[k], m2),
                       (got_opt.v[k], v2)):
            assert got.dtype == w.dtype and torch.equal(got, w), k
    assert all(torch.equal(x, y) for x, y in zip(before, args()))


def test_clip_by_global_norm_matches_reference(qwen):
    _, _, _, _, _, jg = qwen
    for max_norm in (1e-3, 1e6):
        jc, jn = jopt.clip_by_global_norm(jg, max_norm)
        tc, tn = clip_by_global_norm(_t_params(jg), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        for got, want in zip(jax.tree.leaves(interop.params_to_numpy(tc)),
                             jax.tree.leaves(jc)):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=2.0 ** -7, atol=1e-30)


def test_ef_compress_matches_reference(qwen):
    """int8 values equal, scales within one f32 ulp, residuals carried."""
    _, _, _, _, _, jg = qwen
    rng = np.random.default_rng(7)
    jres = jax.tree.map(lambda g: jnp.asarray(
        rng.standard_normal(g.shape).astype(np.float32) * 1e-3), jg)
    jq, js, jr = j_compress(jg, jres)
    tq, ts, tr = ef_compress_tree(_t_params(jg), _t_params(jres))
    for got, want in zip(tree_leaves(tq), jax.tree.leaves(jq)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tree_leaves(ts), jax.tree.leaves(js)):
        w = np.float32(want)
        assert abs(float(got) - float(w)) <= np.spacing(w)
    for got, want in zip(tree_leaves(tr), jax.tree.leaves(jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    back = ef_decompress_tree(tq, ts)
    for g, q, s in zip(tree_leaves(back), tree_leaves(tq), tree_leaves(ts)):
        assert torch.equal(g, q.to(torch.float32) * s)
    zr = zeros_residuals(_t_params(jg))
    assert all(z.dtype == torch.float32 and not z.any()
               for z in tree_leaves(zr))


def _ft_cases():
    tree = ast.parse((ROOT / "tests" / "test_ft.py").read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


@pytest.mark.parametrize("case", _ft_cases())
def test_fleet_monitor_passes_reference_ft_tests(case):
    """Each test of ``tests/test_ft.py``, run on the port's
    ``FleetMonitor``."""
    spec = importlib.util.spec_from_file_location(
        "_reference_test_ft", ROOT / "tests" / "test_ft.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.FleetMonitor = tft.FleetMonitor
    getattr(mod, case)()


def test_scramble32_matches_reference_scramble():
    ranks = np.concatenate([np.arange(0, 4096), np.random.default_rng(1)
                            .integers(0, 2**32, 4096)]).astype(np.uint32)
    x = jnp.asarray(ranks) + jnp.uint32(1)
    x = x * jnp.uint32(0x9E3779B9)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    for n in (512, 151_936, 2**31 - 1):
        want = np.asarray((x % jnp.uint32(n)).astype(jnp.int32))
        got = scramble32(torch.from_numpy(ranks.astype(np.int64)), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_pipeline_is_deterministic_per_host_and_zipf_like_reference():
    cfg = DataConfig(vocab=512, seq_len=64, global_batch=8)
    p = Pipeline(cfg, device="cpu")
    a, b = p.batch_at(3), p.batch_at(3)
    assert a["tokens"].dtype == torch.int32
    assert a["tokens"].shape == a["targets"].shape == (8, 64)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert not torch.equal(a["tokens"], p.batch_at(4)["tokens"])
    hosts = [Pipeline(dataclasses.replace(cfg, n_hosts=2, host_id=h),
                      device="cpu").batch_at(3) for h in (0, 1)]
    assert all(h["tokens"].shape == (4, 64) for h in hosts)
    assert not torch.equal(hosts[0]["tokens"], hosts[1]["tokens"])
    assert torch.equal(Pipeline(cfg, device="cpu").batch_at(3)["tokens"],
                       a["tokens"])
    with pytest.raises(ValueError, match="divide"):
        Pipeline(dataclasses.replace(cfg, n_hosts=3), device="cpu")
    # the token frequencies of the hottest ids against the reference's,
    # over 64 batches each (33,280 tokens): within 5 sigma of a binomial
    big = DataConfig(vocab=512, seq_len=64, global_batch=8)
    jp = JPipeline(JDataConfig(vocab=512, seq_len=64, global_batch=8))
    tp = Pipeline(big, device="cpu")
    tt = np.concatenate([tp.batch_at(i)["tokens"].numpy().ravel()
                         for i in range(64)])
    jt = np.concatenate([np.asarray(jp.batch_at(i)["tokens"]).ravel()
                         for i in range(64)])
    ft = np.bincount(tt, minlength=512) / tt.size
    fj = np.bincount(jt, minlength=512) / jt.size
    hot = np.argsort(-fj)[:16]
    sigma = np.sqrt(fj[hot] * (1 - fj[hot]) * 2 / tt.size)
    assert np.all(np.abs(ft[hot] - fj[hot]) <= 5 * sigma), (ft[hot], fj[hot])
    assert set(np.argsort(-ft)[:4]) == set(hot[:4])


def _patch_mains(monkeypatch, jp, batches):
    """Both drivers start from the reference's weights and read the same
    numpy batches."""
    monkeypatch.setattr(ttrain.Model, "init", lambda self, gen: _t_params(jp))

    def t_batch(self, step):
        toks = batches[step]
        return {"tokens": torch.from_numpy(toks[:, :-1]),
                "targets": torch.from_numpy(toks[:, 1:])}

    def j_batch(self, step):
        toks = batches[step]
        return {"tokens": jnp.asarray(toks[:, :-1]),
                "targets": jnp.asarray(toks[:, 1:])}
    monkeypatch.setattr(ttrain.Pipeline, "batch_at", t_batch)
    monkeypatch.setattr(jtrain.Pipeline, "batch_at", j_batch)


def test_train_main_matches_reference_main(qwen, monkeypatch):
    """Three steps of ``launch.train.main`` on the CPU against the
    reference's ``main`` (its jitted ``step_fn``), with and without
    ``--int8-grads``: the same losses within LOSS_RTOL."""
    jm, jp, _, _, _, _ = qwen
    batches = [_tokens(jm.cfg.vocab, 4, 32, seed=10 + i) for i in range(3)]
    _patch_mains(monkeypatch, jp, batches)
    for extra in ([], ["--int8-grads"]):
        args = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4",
                "--seq", "32", "--lr", "1e-2", *extra]
        want = jtrain.main(args)
        got = ttrain.main(args + ["--device", "cpu"])
        assert len(got) == 3
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                                   err_msg=str(extra))


def test_checkpoint_restart_gives_identical_losses(tmp_path):
    """2 + 2 steps with a restart through ``--ckpt`` equal 4 straight
    steps, bit for bit on the CPU (with the error-feedback residuals)."""
    base = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--int8-grads"]
    straight = ttrain.main(base + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    first = ttrain.main(base + ["--steps", "2", "--ckpt", ck])
    assert ttrain.latest_step(ck) == 2
    second = ttrain.main(base + ["--steps", "2", "--ckpt", ck])
    assert ttrain.latest_step(ck) == 4
    assert first + second == straight


def test_train_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--smoke", "--steps", "1"])
