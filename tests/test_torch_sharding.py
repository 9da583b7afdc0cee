"""The port's serving sharding policy (``repro_torch/distributed/
sharding.py``) and mesh layouts (``repro_torch/launch/mesh.py``) against
the reference's ``repro/distributed/sharding.py``, exactly.

Specs are compared as tuples (``tuple(PartitionSpec)`` on the reference's
side) for every dense and moe LM config of the registry, on abstract
params: the port's ``launch/steps.abstract_params`` (meta tensors) and the
reference's ``jax.eval_shape`` of ``init``, in float form and in index
form (each matrix ``w`` or embedding ``table`` swapped for a ``w_idx`` of
its shape and a 256-entry ``codebook``, the same way on both sides).  No
devices are needed: ``cache_spec`` and ``dp_axes`` take stand-in meshes.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402

LM_ARCHS = ("qwen3-1.7b", "codeqwen1.5-7b", "llama3.2-3b",
            "mistral-large-123b", "qwen3-moe-30b-a3b", "grok-1-314b")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.distributed import sharding as RS
    return RS


class _Stand:
    """A mesh stand-in: the axis names and sizes the spec functions read."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _index_form(tree, leaf):
    """Each 2-D-or-more ``w``/``table`` leaf swapped for ``w_idx`` of its
    shape and a (256,) ``codebook`` (``leaf(shape, integer)`` makes them),
    as ``to_codebook_params`` lays index form out."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("w", "table") and not isinstance(v, dict) \
                and len(v.shape) >= 2:
            out["w_idx"] = leaf(tuple(v.shape), True)
            out["codebook"] = leaf((256,), False)
        else:
            out[k] = _index_form(v, leaf)
    return out


def _ref_specs(RS, arch: str, index: bool):
    import jax
    import jax.numpy as jnp

    import repro.configs as C
    from repro.models.model_zoo import build

    params = jax.eval_shape(build(C.get(arch)).init, jax.random.PRNGKey(0))
    if index:
        params = _index_form(params, lambda s, i: jax.ShapeDtypeStruct(
            s, jnp.int8 if i else jnp.float32))
    specs = RS.serve_param_specs(params)
    return jax.tree_util.tree_map(tuple, specs,
                                  is_leaf=lambda x: isinstance(
                                      x, jax.sharding.PartitionSpec))


def _port_params(arch: str, index: bool):
    params = abstract_params(tbuild(TC.get(arch)))
    if index:
        params = _index_form(params, lambda s, i: torch.empty(
            s, dtype=torch.int8 if i else torch.float32, device="meta"))
    return params


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


@pytest.mark.parametrize("index", [False, True], ids=["float", "index"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_param_specs_equal_reference(ref, arch, index):
    want = _ref_specs(ref, arch, index)
    got = TS.serve_param_specs(_port_params(arch, index))
    assert got == want
    sharded = [p for p, s in _paths(got) if "model" in s]
    if TC.get(arch).family == "dense":   # every block matmul, nothing else
        assert sorted(p.split("/")[2] for p in sharded) == sorted(
            ["wq", "wk", "wv", "wo", "w1", "w3", "w2"])
    assert all(p.startswith("blocks/") for p in sharded)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rule_equal_reference_on_every_leaf(ref, arch, fsdp):
    for index in (False, True):
        for path, t in _paths(_port_params(arch, index)):
            shape = tuple(t.shape)
            assert TS._rule(path, shape, fsdp) == \
                tuple(ref._rule(path, shape, fsdp)), path


@pytest.mark.parametrize("axes", [{"data": 1, "model": 2},
                                  {"data": 4, "model": 4},
                                  {"pod": 2, "data": 16, "model": 16}])
def test_cache_spec_and_dp_axes_equal_reference(ref, axes):
    mesh = _Stand(axes)
    assert TS.dp_axes(mesh) == tuple(ref.dp_axes(mesh))
    for kind in ("kv", "ssm", "vec"):
        assert TS.cache_spec(mesh, kind) == tuple(ref.cache_spec(mesh, kind))
    with pytest.raises(ValueError) as want:
        ref.cache_spec(mesh, "paged")
    with pytest.raises(ValueError) as got:
        TS.cache_spec(mesh, "paged")
    assert str(got.value) == str(want.value)


def test_local_slice_cuts_the_named_dims():
    t = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
    for m in range(2):
        mesh = TM.Mesh({"data": 1, "model": 2}, {"data": 0, "model": m})
        col = TS.local_slice(t, (None, None, "model"), mesh)
        row = TS.local_slice(t, (None, "model", None), mesh)
        assert torch.equal(col, t[:, :, 3 * m:3 * m + 3])
        assert torch.equal(row, t[:, 2 * m:2 * m + 2])
        assert col.is_contiguous() and col.data_ptr() != t.data_ptr()
        assert TS.local_slice(t, (None, None, None), mesh) is t
    with pytest.raises(ValueError, match="does not split"):
        TS.local_slice(torch.zeros(3, 5), (None, "model"), mesh)


def test_meshes_without_a_world():
    """No initialized world: one rank, and the reference's rule for a
    world too small for the mesh asked, (world, 1).  The production
    layouts are layouts only."""
    m = TM.make_local_mesh(1, 4)
    assert (m.axis_names, m.shape, m.coords, m.group, m.tp) == (
        ("data", "model"), {"data": 1, "model": 1},
        {"data": 0, "model": 0}, None, 1)
    assert TM.make_production_mesh() == TM.MeshLayout(
        ("data", "model"), {"data": 16, "model": 16})
    assert TM.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
