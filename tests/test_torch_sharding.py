"""The port's sharding rules (src/repro_torch/distributed/sharding.py)
against the reference's (src/repro/distributed/sharding.py), exactly.

Counterparts of tests/test_sharding.py:75–199.  The reference's rules run
in this process on a ``jax.sharding.AbstractMesh`` of the same axis
sizes (no forced host devices), the port's on a ``ServingMesh`` of CPU
devices.  Trees are the reference's own: ``jax.eval_shape`` of
``init_params`` and ``init_caches`` for every family's reduced config,
AdamW states for ZeRO, and the synthetic trees of test_sharding.py.  A
spec is compared as a tuple, entry by entry.  The port's own param tree
(per-layer lists, from ``bridge.params_from_numpy``) must get each
reference leaf's spec less its stacked layer dims.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RP

from repro.distributed import sharding as RS
from repro.models import model as RM
from repro.models import transformer as RT
from repro.models.base import get_arch as ref_arch
from repro.optim import adamw as RA
from repro_torch.bridge import params_from_numpy
from repro_torch.distributed import sharding as PS
from repro_torch.launch import mesh as PMesh
from repro_torch.models.base import get_arch

FAMILIES = ["yi-9b", "mamba2-370m", "olmoe-1b-7b", "zamba2-2.7b",
            "whisper-tiny", "llava-next-mistral-7b"]
# (data, model) axis sizes
MESHES = [(1, 2), (2, 2), (1, 4), (4, 1)]


def _meshes(data, model):
    ref = AbstractMesh((data, model), ("data", "model"))
    port = PMesh.make_serving_mesh(data, tp=model,
                                   devices=["cpu"] * (data * model))
    return ref, port


def _flat(tree, path=""):
    """path -> spec tuple, over dicts, lists and tuples (NamedTuples
    too); a reference or port PartitionSpec is a leaf."""
    if isinstance(tree, (RP, PS.P)):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(type(tree))
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out


def _ref_params(aid):
    cfg = ref_arch(aid).reduced()
    return jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))


def _ref_caches(aid, batch, kv_dtype=None):
    cfg = ref_arch(aid).reduced()
    return jax.eval_shape(lambda: RT.init_caches(None, cfg, batch, 64,
                                                 kv_dtype=kv_dtype))


@pytest.fixture(params=["fsdp", "ep2d"])
def moe_mode(request):
    RS.set_moe_mode(request.param)
    PS.set_moe_mode(request.param)
    yield request.param
    RS.set_moe_mode("fsdp")
    PS.set_moe_mode("fsdp")


def _leaf(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


_PARAMS = {
    "embed": {"table": _leaf(512, 64)},
    "layers": {
        "attn": {"wq": {"w": _leaf(64, 64)},
                 "wo": {"w": _leaf(64, 64)}},
        "mlp": {"down": {"w": _leaf(256, 64)}},
        "ln1": {"scale": _leaf(64)},
    },
}


# ------------------------------------------------------------ meshes --
def test_serving_mesh_geometry():
    ref, port = _meshes(2, 2)
    assert port.shape == dict(ref.shape) == {"data": 2, "model": 2}
    assert tuple(port.axis_names) == tuple(ref.axis_names)
    subs = PMesh.replica_submeshes(port)
    assert [s.devices.shape for s in subs] == [(1, 2), (1, 2)]
    assert all(s.shape == {"data": 1, "model": 2} for s in subs)
    assert len(PMesh.replica_devices(port)) == 2
    with pytest.raises(AssertionError):
        PMesh.make_serving_mesh(8, tp=2, devices=["cpu"] * 4)


# ------------------------------------------------------- param specs --
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("aid", FAMILIES)
def test_param_specs_equal_reference(aid, mesh, moe_mode):
    ref_mesh, port_mesh = _meshes(*mesh)
    tree = _ref_params(aid)
    want = _flat(RS.param_specs(tree, ref_mesh))
    got = _flat(PS.param_specs(tree, port_mesh))
    assert got == want


def test_param_specs_serving_mesh():
    ref_mesh, port_mesh = _meshes(2, 2)
    specs = PS.param_specs(_PARAMS, port_mesh)
    assert _flat(specs) == _flat(RS.param_specs(_PARAMS, ref_mesh))
    assert specs["embed"]["table"] == PS.P("model", None)
    assert specs["layers"]["attn"]["wq"]["w"] == PS.P(None, "model")
    assert specs["layers"]["attn"]["wo"]["w"] == PS.P("model", None)
    assert specs["layers"]["ln1"]["scale"] == PS.P(None)


def test_param_specs_drop_indivisible_dims():
    ref_mesh, port_mesh = _meshes(2, 2)
    odd = {"attn": {"wq": {"w": _leaf(64, 63)}},
           "embed": {"table": _leaf(51865, 64)}}   # whisper's vocab
    got = PS.param_specs(odd, port_mesh)
    assert _flat(got) == _flat(RS.param_specs(odd, ref_mesh))
    assert got["attn"]["wq"]["w"] == PS.P(None, None)
    assert got["embed"]["table"] == PS.P(None, None)


def test_param_specs_filter_pod_axis():
    ref3 = AbstractMesh((1, 2, 2), ("pod", "data", "model"))
    grid = np.empty(4, dtype=object)
    grid[:] = [torch.device("cpu")] * 4
    port3 = PMesh.ServingMesh(grid.reshape(1, 2, 2),
                              ("pod", "data", "model"))
    assert port3.shape == dict(ref3.shape)
    assert _flat(PS.param_specs(_PARAMS, port3)) == \
        _flat(RS.param_specs(_PARAMS, ref3))
    assert tuple(PS.batch_spec(port3)) == tuple(RS.batch_spec(ref3)) \
        == (("pod", "data"),)
    for mesh in MESHES:
        ref_mesh, port_mesh = _meshes(*mesh)
        assert tuple(PS.batch_spec(port_mesh)) == \
            tuple(RS.batch_spec(ref_mesh)) == ("data",)


def test_filter_spec_drops_absent_axes():
    _, port = _meshes(1, 2)
    with PS.use_mesh(port):
        assert PS._filter_spec(("pod", ("pod", "data"), "model", None)) \
            == PS.P(None, ("data",), "model", None)
    assert PS._filter_spec(("model",)) == PS.P(None)


# ---------------------------------------------------------- ZeRO specs --
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("aid", FAMILIES)
def test_zero_specs_equal_reference(aid, mesh, moe_mode):
    ref_mesh, port_mesh = _meshes(*mesh)
    params = _ref_params(aid)
    opt = jax.eval_shape(lambda: RA.init(params))
    want = RS.zero_specs(opt, params, ref_mesh)
    got = PS.zero_specs(opt, params, port_mesh)
    assert type(got).__name__ == "AdamWState"
    assert _flat(got.m) == _flat(want.m) and _flat(got.v) == _flat(want.v)
    assert tuple(got.step) == tuple(want.step) == ()


def test_zero_specs_extend_model_dim():
    ref_mesh, port_mesh = _meshes(2, 2)
    params = {"mlp": {"down": {"w": _leaf(256, 64)}}}
    st = PS.zero_specs(None, params, port_mesh)
    assert st.m["mlp"]["down"]["w"] == PS.P(("model", "data"), None)
    assert _flat(st.m) == _flat(RS.zero_specs(None, params, ref_mesh).m)


# --------------------------------------------------------- cache specs --
@pytest.mark.parametrize("mode", ["minor", "seq"])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("aid", FAMILIES)
def test_cache_specs_equal_reference(aid, mesh, mode):
    """The reference's tuple layout of every reduced family, native and
    int8 (scale leaves) K/V."""
    ref_mesh, port_mesh = _meshes(*mesh)
    for kv in (None, "int8"):
        caches = _ref_caches(aid, 2, kv)
        assert isinstance(caches, tuple)
        want = _flat(RS.cache_specs(caches, ref_mesh, 2, mode=mode))
        assert _flat(PS.cache_specs(caches, port_mesh, 2, mode=mode)) == want


@pytest.mark.parametrize("mode", ["minor", "seq"])
def test_cache_specs_tuple_layout(mode):
    ref_mesh, port_mesh = _meshes(2, 2)
    caches = ({"k": _leaf(2, 64, 4, 16), "v": _leaf(2, 64, 4, 16)},)
    got = PS.cache_specs(caches, port_mesh, batch=2, mode=mode)
    assert _flat(got) == _flat(RS.cache_specs(caches, ref_mesh, batch=2,
                                              mode=mode))
    want = (("data", None, None, "model") if mode == "minor"
            else ("data", "model", None, None))
    assert tuple(got[0]["k"]) == want


@pytest.mark.parametrize("mode", ["minor", "seq"])
def test_cache_specs_stacked_layout(mode):
    ref_mesh, port_mesh = _meshes(2, 2)
    stacked = {"k": _leaf(3, 2, 64, 4, 16),           # [G, B, S, H, hd]
               "ssm": _leaf(3, 2, 8, 16, 32)}
    got = PS.cache_specs(stacked, port_mesh, batch=2, mode=mode)
    assert _flat(got) == _flat(RS.cache_specs(stacked, ref_mesh, batch=2,
                                              mode=mode))
    if mode == "minor":
        assert tuple(got["k"]) == (None, "data", None, None, "model")


def test_cache_specs_indivisible_batch_falls_back():
    ref_mesh, port_mesh = _meshes(4, 1)
    caches = {"k": _leaf(3, 64, 4, 16)}   # batch 3 % data 4 != 0
    got = PS.cache_specs(caches, port_mesh, batch=3)
    assert _flat(got) == _flat(RS.cache_specs(caches, ref_mesh, batch=3))
    assert tuple(got["k"])[0] is None and "data" in tuple(got["k"])


def test_cache_specs_on_the_ports_own_caches():
    """The port's per-layer caches ([B, ...] leaves) get the reference's
    per-group leaves' specs (the tuple layout holds one layer a group)."""
    from repro_torch.models.transformer import init_caches
    ref_mesh, port_mesh = _meshes(1, 2)
    for aid in ("yi-9b", "mamba2-370m", "olmoe-1b-7b"):
        cfg = get_arch(aid).reduced()
        port = init_caches(None, cfg, 2, 64, device="cpu")
        want = RS.cache_specs(_ref_caches(aid, 2), ref_mesh, 2)
        got = PS.cache_specs(port, port_mesh, 2)
        assert [tuple(s) for c in got for s in c.values()] == \
            [tuple(s) for c in want for s in c.values()]


# ----------------------------------------------------- the port's tree --
def _strip(path):
    return "/".join(p for p in path.split("/") if p and not p.isdigit())


@pytest.mark.parametrize("aid", FAMILIES)
def test_port_tree_specs_follow_reference_leaves(aid, moe_mode):
    """Every leaf of the port's params gets the spec of the reference
    leaf ``params_from_numpy`` made it from, less the stacked dims."""
    ref_mesh, port_mesh = _meshes(1, 2)
    rcfg = ref_arch(aid).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    port = params_from_numpy(tree, get_arch(aid).reduced(), "cpu")
    want = _flat(RS.param_specs(tree, ref_mesh))
    shapes = {p: np.asarray(a).ndim for p, a in _flat_arrays(tree).items()}
    got = _flat(PS.param_specs(port, port_mesh))
    ndims = {p: t.dim() for p, t in _flat_arrays(port).items()}
    assert {_strip(p) for p in got} == {_strip(p) for p in want}
    for path, spec in got.items():
        ref_path = "/" + _strip(path)
        drop = shapes[ref_path] - ndims[path]
        assert spec == want[ref_path][drop:], (path, spec, want[ref_path])
        assert all(s is None for s in want[ref_path][:drop])
    assert any(s for spec in got.values() for s in spec)


def _flat_arrays(tree, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat_arrays(v, f"{path}/{k}"))
    return out


def test_set_moe_mode_switches_the_expert_rules():
    ref_mesh, port_mesh = _meshes(1, 2)
    tree = _ref_params("olmoe-1b-7b")
    for mode, gate in (("ep2d", (None, "data", None, "model")),
                       ("fsdp", (None, "model", None, "data"))):
        PS.set_moe_mode(mode)
        RS.set_moe_mode(mode)
        try:
            got = PS.param_specs(tree, port_mesh)
            assert tuple(got["layers"]["mlp"]["gate"]) == gate
            assert _flat(got) == _flat(RS.param_specs(tree, ref_mesh))
        finally:
            PS.set_moe_mode("fsdp")
            RS.set_moe_mode("fsdp")
    with pytest.raises(AssertionError):
        PS.set_moe_mode("nope")


# ------------------------------------------------ shard_hint / use_mesh --
def test_shard_hint_identity_without_mesh():
    x = torch.ones((4, 8))
    assert PS.shard_hint(x, ("data", "model")) is x


def test_shard_hint_identity_under_mesh():
    _, port = _meshes(2, 2)
    x = torch.ones((2, 8))
    with PS.use_mesh(port) as m:
        assert m is port and PS._ACTIVE_MESH is port
        assert PS.shard_hint(x, ("data", None)) is x
    assert PS._ACTIVE_MESH is None
    assert PS.shard_hint(x, ("data", None)) is x
