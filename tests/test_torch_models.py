"""The port's dense model on the CPU against the JAX reference, at the
``qwen3-0.6b`` smoke config (qk_norm, tied embedding) and the
``qwen2.5-32b`` smoke config (qkv_bias, separate head), with the reference's
own initial weights carried into the port by ``interop.params_from_numpy``.

Tolerance: logits and caches within rtol 2e-2, atol 6.25e-2 of the
reference's, and argmax agreement on at least 90 % of the positions.  Both
run bf16 weights and activations; XLA and PyTorch round their bf16 matmuls
and their f32 sin/pow in RoPE at different places, so about one element in
a thousand lands one or two bf16 ulps away (an ulp is 0.03125 for |x| in
[4, 8)); atol is two such ulps.  Tighter than ``tests/test_archs_smoke.py``'s
decode-vs-prefill rtol 1e-1 / atol 1.5e-1.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = ["qwen3-0.6b", "qwen2.5-32b"]
RTOL, ATOL = 2e-2, 6.25e-2
B, S = 2, 128        # two attention chunks of the smoke config's 64


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model, port params)."""
    arch = request.param
    jm = JModel(j_get_config(arch, smoke=True))
    jp = unbox(jm.init(jax.random.key(0)))
    if jm.cfg.qkv_bias:   # the reference inits biases to 0: make them count
        rng = np.random.default_rng(1)
        jp["blocks"] = dict(jp["blocks"], **{
            n: jnp.asarray(rng.standard_normal(jp["blocks"][n].shape) * 0.1,
                           jnp.float32) for n in ("bq", "bk", "bv")})
    tm = Model(get_config(arch, smoke=True), device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return arch, jm, jp, tm, tp


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _check_logits(got: torch.Tensor, want, what: str):
    g = got.to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)
    agree = (g.argmax(-1) == w.argmax(-1)).mean()
    assert agree >= 0.9, f"{what}: argmax agreement {agree}"


def test_configs_registry_matches_reference():
    from repro.configs import ALL_ARCHS as J_ALL
    assert ALL_ARCHS == J_ALL
    for arch in ALL_ARCHS:
        for smoke in (False, True):
            assert (get_config(arch, smoke).__dict__
                    == j_get_config(arch, smoke).__dict__), (arch, smoke)


def test_forward_matches_reference(pair):
    arch, jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, B, S)
    jl, jaux, jc = jtfm.forward(jm.cfg, jp, jnp.asarray(toks),
                                return_cache=True)
    tl, taux, tc = ttfm.forward(tm.cfg, tp, torch.from_numpy(toks),
                                return_cache=True)
    assert tl.dtype == torch.bfloat16 and float(taux) == float(jaux) == 0.0
    _check_logits(tl, jl, f"{arch} forward")
    for got, want, name in zip(tc, jc, ("k", "v")):
        assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{arch} cache {name}")


def test_prefill_and_decode_sequence_match_reference(pair):
    """``prefill`` of 16 tokens, then 16 ``decode_step``s fed the same
    tokens as the reference, each step's logits held to the reference's."""
    arch, jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, B, 32, seed=3)
    jl, _ = jm.prefill(jp, jnp.asarray(toks[:, :16]))
    tl, caches = tm.prefill(tp, torch.from_numpy(toks[:, :16]))
    assert tuple(tl.shape) == (B, 1, tm.cfg.vocab)
    assert tuple(caches[0].shape) == (tm.cfg.n_layers, B, 16, tm.cfg.n_kv,
                                      tm.cfg.hd)
    _check_logits(tl, jl, f"{arch} prefill")
    jst = jm.init_decode_state(B, 32)
    tst = tm.init_decode_state(B, 32)
    jdec = jax.jit(jm.decode_step)
    for t in range(32):
        jlg, jst = jdec(jp, jst, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tlg, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t:t + 1]),
                                  t)
        if t >= 16:
            _check_logits(tlg, jlg, f"{arch} decode step {t}")
    np.testing.assert_allclose(tst["k"].to(torch.float32).numpy(),
                               np.asarray(jst["k"], np.float32), rtol=RTOL,
                               atol=ATOL)


def test_decode_matches_own_prefill(pair):
    """The port's decode path agrees with its own forward, as
    ``tests/test_archs_smoke.py`` checks the reference."""
    arch, _, _, tm, tp = pair
    toks = _tokens(tm.cfg, B, 8, seed=4)
    full, _, _ = ttfm.forward(tm.cfg, tp, torch.from_numpy(toks))
    st = tm.init_decode_state(B, 8)
    outs = []
    for t in range(8):
        lg, st = tm.decode_step(tp, st, torch.from_numpy(toks[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    _check_logits(torch.stack(outs, 1), full.to(torch.float32).numpy(),
                  f"{arch} decode vs prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_decode_state_shapes_match_reference(arch):
    jm = JModel(j_get_config(arch, smoke=True))
    tm = Model(get_config(arch, smoke=True), device="cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           unbox(jm.init_abstract()))
    tp = tm.init(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).removeprefix("torch.")),
                           tp)
    assert tshapes == jshapes
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == jm.n_params()
    js = jm.init_decode_state(3, 20)
    ts = tm.init_decode_state(3, 20)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        assert ts[k].dtype == torch.bfloat16 and js[k].dtype == jnp.bfloat16
        assert not ts[k].any()
    # the port's init is seeded: same generator seed, same weights
    again = tm.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["blocks"]["wq"], tp["blocks"]["wq"])


def test_params_round_trip_keeps_bits():
    jm = JModel(j_get_config("qwen3-0.6b", smoke=True))
    np_tree = jax.tree.map(np.asarray, unbox(jm.init(jax.random.key(5))))
    back = interop.params_to_numpy(interop.params_from_numpy(np_tree, "cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.dtype == (np.float32 if a.dtype == jnp.bfloat16 else a.dtype)
        assert b.shape == a.shape
        assert np.array_equal(b.astype(a.dtype).view(np.uint8),
                              a.view(np.uint8)), path


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "hubert-xlarge",
                                  "phi-3-vision-4.2b"])
def test_other_families_raise_naming_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP item A15"):
        Model(get_config(arch, smoke=True), device="cpu")


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config("qwen3-0.6b", smoke=True))
