"""The port's sharding layer (``repro_torch.dist.sharding``,
``dist.ctx``, ``launch.mesh``) and abstract model API
(``Model.init_abstract``, ``param_axes``, ``n_params``,
``decode_state_spec``, ``input_specs``) on the CPU against the JAX
reference: every parameter's logical axes; every parameter, batch and
decode-state leaf's spec and per-device shape for all 10 architectures
(full width and smoke) on the 16 x 16 and 2 x 16 x 16 production meshes
(``jax.sharding.AbstractMesh``: no devices) and on a 2 x 4 CPU mesh;
parameter counts, input specs and ``model_flops`` for every (arch x cell);
the MoE dispatch's ``rows`` under a mesh.  All exact (integers and
names)."""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.dist import ctx as jctx  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.rooflines.roofline import model_flops as j_model_flops  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.dist import ctx, sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.rooflines.roofline import model_flops  # noqa: E402

# (arch, smoke): every registered config at both sizes
ARCHS = [(a, s) for a in ALL_ARCHS for s in (False, True)]
IDS = [f"{a}{'-smoke' if s else ''}" for a, s in ARCHS]
# the production meshes (shape only) and the 2 x 4 CPU mesh of the 8 host
# devices tests/conftest.py sets up
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
CELLS = {"train_4k": ("train", 4096, 256),
         "prefill_32k": ("prefill", 32768, 32),
         "decode_32k": ("decode", 32768, 128),
         "long_500k": ("decode", 524288, 1)}


def _j_mesh(name):
    shape, names = MESHES[name]
    if name == "2x4":
        return jax.make_mesh(shape, names)
    return AbstractMesh(shape, names)


def _t_mesh(name):
    if name == "16x16":
        return tmesh.make_production_mesh()
    if name == "2x16x16":
        return tmesh.make_production_mesh(multi_pod=True)
    return tmesh.make_local_mesh(2, "cpu", model=4)


def _axes_tree(boxed):
    if isinstance(boxed, dict):
        return {k: _axes_tree(v) for k, v in boxed.items()}
    return tuple(boxed.axes)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _same_sharding(j_named, j_shape, t_sh, what):
    want_spec = tuple(j_named.spec) + (None,) * (len(j_shape)
                                                  - len(j_named.spec))
    assert tuple(t_sh.spec) == want_spec, what
    assert t_sh.shape == tuple(j_shape), what
    assert t_sh.local_shape == tuple(j_named.shard_shape(tuple(j_shape))), \
        what


@pytest.mark.parametrize("arch,smoke", ARCHS, ids=IDS)
def test_param_axes_and_abstract_model(arch, smoke):
    """Every leaf's logical axes, shape and dtype; the abstract model is
    meta tensors; n_params equal."""
    jm = JModel(j_get_config(arch, smoke=smoke))
    boxed = jm.init_abstract()
    tm = Model(get_config(arch, smoke=smoke), device="cpu")
    assert tm.param_axes() == _axes_tree(boxed)
    params = tm.init_abstract()
    jl = list(_leaves(unbox(boxed)))
    tl = list(_leaves(params))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
    assert tm.n_params() == jm.n_params()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,smoke", ARCHS, ids=IDS)
def test_param_specs_and_local_shapes(arch, smoke, mesh):
    jm = JModel(j_get_config(arch, smoke=smoke))
    boxed = jm.init_abstract()
    jps = jsh.param_shardings(boxed, _j_mesh(mesh))
    tm = Model(get_config(arch, smoke=smoke), device="cpu")
    tps = sharding.param_shardings(tm.init_abstract(), tm.param_axes(),
                                   _t_mesh(mesh))
    shapes = dict(_leaves(unbox(boxed)))
    jl = dict(_leaves(jps))
    for path, t_sh in _leaves(tps):
        _same_sharding(jl[path], shapes[path].shape, t_sh, (arch, path))
    assert len(jl) == len(list(_leaves(tps)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,smoke", ARCHS, ids=IDS)
def test_batch_and_decode_state_specs(arch, smoke, mesh):
    """Input batches of the train and prefill cells and the decode state
    and token of the decode cells (smoke configs at their own seq)."""
    jm = JModel(j_get_config(arch, smoke=smoke))
    tm = Model(get_config(arch, smoke=smoke), device="cpu")
    jmesh, t_mesh = _j_mesh(mesh), _t_mesh(mesh)
    for cell, (kind, seq, gb) in CELLS.items():
        if smoke:
            seq, gb = (128 if kind != "decode" else 256), 16
        cfg = tm.cfg
        if kind == "decode" and not cfg.has_decode:
            with pytest.raises(ValueError):
                tm.input_specs(kind, seq, gb)
            continue
        jspec = jm.input_specs(kind, seq, gb)
        tspec = tm.input_specs(kind, seq, gb)
        if kind == "decode":
            jstate, tstate = jspec.pop("state"), tspec.pop("state")
            jsh_ = dict(_leaves(jsh.decode_state_shardings(jstate, jmesh)))
            jshape = dict(_leaves(jstate))
            for path, t_sh in _leaves(sharding.decode_state_shardings(
                    tstate, t_mesh)):
                _same_sharding(jsh_[path], jshape[path].shape, t_sh,
                               (arch, cell, path))
            assert sorted(jsh_) == sorted(p for p, _ in _leaves(tstate))
            for path, t in _leaves(tstate):
                assert t.is_meta and str(t.dtype).removeprefix("torch.") \
                    == str(jshape[path].dtype), path
            jspec.pop("pos"), tspec.pop("pos")
        assert sorted(jspec) == sorted(tspec), cell
        jb = dict(_leaves(jsh.batch_shardings(jspec, jmesh)))
        for path, t_sh in _leaves(sharding.batch_shardings(tspec, t_mesh)):
            _same_sharding(jb[path], dict(_leaves(jspec))[path].shape, t_sh,
                           (arch, cell, path))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_n_params_and_model_flops_every_cell(arch):
    """Shapes and dtypes of every cell's inputs (the vlm's text is seq -
    n_patches long, the encoder takes (B, 0) tokens), and model_flops equal
    to the float for every (arch x cell)."""
    jm, tm = JModel(j_get_config(arch)), Model(get_config(arch), "cpu")
    n = tm.n_params()
    assert n == jm.n_params()
    for cell, (kind, seq, gb) in CELLS.items():
        assert model_flops(tm.cfg, kind, seq, gb, n) == \
            j_model_flops(jm.cfg, kind, seq, gb, n), cell
        if kind == "decode" and not tm.cfg.has_decode:
            continue
        jspec, tspec = jm.input_specs(kind, seq, gb), \
            tm.input_specs(kind, seq, gb)
        jl, tl = dict(_leaves(jspec)), dict(_leaves(tspec))
        assert sorted(jl) == sorted(tl), cell
        for path, t in tl.items():
            assert t.is_meta and tuple(t.shape) == tuple(jl[path].shape) \
                and str(t.dtype).removeprefix("torch.") \
                == str(jl[path].dtype), (cell, path)


def test_spec_for_first_fit_rules():
    """The rules one by one, against the reference: first fit, each mesh
    axis used once, indivisible and unknown axes replicated."""
    cases = [((256, 64), ("batch", None)), ((6, 64), ("batch", None)),
             ((64, 32), ("embed", "embed")), ((32, 48), ("heads", "mlp")),
             ((7, 5), ("vocab", "embed")), ((64,), ()),
             ((64, 64, 3), ("act_rows", "experts")),
             ((16, 16), ("layers", "head_dim")), ((32, 32), (None, "kv"))]
    for mesh in MESHES:
        for shape, axes in cases:
            want = jsh.spec_for(shape, axes, _j_mesh(mesh))
            got = sharding.spec_for(shape, axes, _t_mesh(mesh))
            assert isinstance(got, sharding.P)
            assert tuple(got) == tuple(want) + (None,) * (
                len(shape) - len(want)), (mesh, shape, axes)
    assert sharding.LOGICAL_RULES == jsh.LOGICAL_RULES


def test_meshes_shapes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).size == 512
    assert tmesh.make_local_mesh(4, "cpu").shape == {"data": 4, "model": 1}
    assert tmesh.make_local_mesh(1, "cpu", model=8).shape == \
        {"data": 1, "model": 8}
    with pytest.raises(ValueError):
        tmesh.make_local_mesh(1, "cpu", model=0)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class DM:      # what to_placements reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

    P = sharding.P
    assert sharding.to_placements(P("model", None, "data"), DM()) == \
        [Replicate(), Shard(2), Shard(0)]
    assert sharding.to_placements(P(("pod", "data"), None), DM()) == \
        [Shard(0), Shard(0), Replicate()]
    assert sharding.to_placements(P(None, None), DM()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="not in"):
        sharding.to_placements(P("expert"), DM())
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(P(("data", "pod")), DM())


def test_ctx_use_mesh_and_shard():
    m2, m4 = tmesh.make_local_mesh(2, "cpu"), tmesh.make_local_mesh(4, "cpu")
    x = torch.arange(6.0)
    assert ctx.current_mesh() is None and ctx.shard(x, ("batch",)) is x
    with ctx.use_mesh(m2):
        with ctx.use_mesh(m4):
            assert ctx.current_mesh() is m4
            assert ctx.shard(x, ("batch",)) is x
        assert ctx.current_mesh() is m2
    assert ctx.current_mesh() is None
    with pytest.raises(RuntimeError):
        with ctx.use_mesh(m2):
            raise RuntimeError
    assert ctx.current_mesh() is None


@pytest.mark.parametrize("data", [2, 4])
def test_moe_rows_from_the_mesh(data):
    """Under a mesh the MoE layer groups its dispatch per data shard (rows =
    pod x data), as the reference's ``_moe_fwd`` does under its mesh: the
    same bits as ``moe_ffn(..., rows=data)``, and within the model tests'
    tolerance of the reference's ``moe_ffn(..., rows=data)`` on the same
    inputs, its expert choices replayed (near-ties flip under other
    rounding).  Without a mesh, or with ``moe_local_dispatch`` off, rows =
    1.  The reference's own ``_moe_fwd`` under a 2-way data mesh gives the
    aux loss of its rows = 2."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    jcfg = j_get_config("deepseek-moe-16b", smoke=True)
    rng = np.random.default_rng(data)
    b, s, d = 2, 24, cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    blk = {k: v[0] for k, v in tfm.init_params(cfg, gen)["blocks"].items()}
    jblk = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in blk.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    xn = jtfm.rms_norm(xj, jblk["ln2"]).reshape(b * s, d)
    choices = np.array(jmoe.route_topk(xn @ jblk["router"], jcfg.top_k)[1])
    ffn = ("router", "eg", "eu", "ed", "sg", "su", "sd")

    def direct(rows):
        xnt = tfm.rms_norm(xt, blk["ln2"]).reshape(b * s, d)
        with tmoe.pinned_routing(replay=[choices]):
            y, aux = tmoe.moe_ffn(xnt, *(blk.get(k) for k in ffn),
                                  top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  rows=rows)
        return (xt + y.reshape(b, s, d)).float().numpy(), float(aux)

    def port(mesh, c=cfg):
        with ctx.use_mesh(mesh) if mesh is not None else nullcontext(), \
                tmoe.pinned_routing(replay=[choices]) as flips:
            y, aux = tfm._moe_fwd(c, xt, blk)
        assert flips[1] == b * s and flips[0] <= b * s // 10, flips
        return y.float().numpy(), float(aux)

    mesh = tmesh.make_local_mesh(data, "cpu")
    for got, rows in ((port(mesh), data), (port(None), 1),
                      (port(mesh, _no_local(cfg)), 1)):
        want = direct(rows)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert port(mesh)[1] != port(None)[1]
    y, aux = jmoe.moe_ffn(xn, *(jblk.get(k) for k in ffn), top_k=jcfg.top_k,
                          capacity_factor=jcfg.capacity_factor, rows=data)
    np.testing.assert_allclose(port(mesh)[0], np.asarray(
        (xj + y.reshape(b, s, d)).astype(jnp.float32)), rtol=2e-2,
        atol=6.25e-2)
    np.testing.assert_allclose(port(mesh)[1], float(aux), rtol=1e-4)
    if data == 2:
        with jctx.use_mesh(jax.make_mesh((2, 1), ("data", "model"))):
            _, jaux = jtfm._moe_fwd(jcfg, xj, jblk)
        np.testing.assert_allclose(float(jaux), float(aux), rtol=1e-6)


def _no_local(cfg):
    import dataclasses
    return dataclasses.replace(cfg, moe_local_dispatch=False)
