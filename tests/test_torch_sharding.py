"""The port's logical sharding (``repro_torch.distribution.sharding``,
``Model.param_specs`` / ``batch_shardings``, ``runtime.steps``'s train
state layout, ``launch.mesh``'s layouts, ``runtime.elastic``'s mesh
helpers) against the reference's, on the CPU and without a world: the
reference's ``spec_for`` on ``jax.sharding.AbstractMesh``, the port's on
``launch.mesh.MeshShape``.

Everything here is exact: the specs, shapes, dtypes and error messages
must be equal.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get as ref_get
from repro.configs.base import registry as ref_registry
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.distribution import sharding as RSH
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro.runtime import elastic as RE
from repro.runtime import steps as RS
from repro_torch.configs.base import get
from repro_torch.configs.shapes import SHAPES
from repro_torch.distribution import sharding as SH
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.runtime import elastic as E
from repro_torch.runtime import steps as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

ARCHS = sorted(ref_registry())
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = ({}, {"moe_sharding": "ep"}, {"moe_sharding": "cap"},
            {"fsdp": False}, {"fsdp_pods": True},
            {"fsdp_pods": True, "moe_sharding": "ep"},
            {"seq_shard_activations": True})
# the reference's knob the port leaves out (no step reads it): its specs
# with it on are the port's without it
REF_ONLY = ({"compress_pod_grads": True},)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (a spec, sharding or meta a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _spec(x):
    return x.spec if hasattr(x, "spec") else x


def _same_specs(mine, theirs, what):
    m, t = _flat(mine), _flat(theirs)
    assert list(m) == list(t), what
    for k in t:
        got, want = _spec(m[k]), _spec(t[k])
        assert isinstance(got, SH.Spec), (what, k, got)
        assert got == want and tuple(got) == tuple(want), (what, k, got,
                                                           want)


def test_options_rules_are_the_references():
    for v in VARIANTS + ({"moe_sharding": "tp", "fsdp": False,
                          "fsdp_pods": True},):
        assert RunOptions(**v).rules() == RefOptions(**v).rules(), v
    assert SH.DEFAULT_RULES == RSH.DEFAULT_RULES
    for v in REF_ONLY:
        assert RefOptions(**v).rules() == RunOptions().rules(), v
        with pytest.raises(TypeError):
            RunOptions(**v)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_meta_axes_are_the_references(arch):
    """Every leaf's shape, init, dtype, fan-in dims and logical axes, for
    float32 and bfloat16 params (the cast keeps the axes)."""
    for opts in ({}, {"param_dtype": "bfloat16"}):
        mine = _flat(Model(get(arch), RunOptions(**opts)).meta())
        theirs = _flat(RefModel(ref_get(arch), RefOptions(**opts)).meta())
        assert list(mine) == list(theirs), arch
        for k, t in theirs.items():
            m = mine[k]
            assert (m.shape, m.init, m.dtype, m.fan_in_dims, m.axes) == (
                t.shape, t.init, t.dtype, t.fan_in_dims, t.axes), (arch, k)
    mc = _flat(Model(get(arch)).cache_meta(4, 64))
    rc = _flat(RefModel(ref_get(arch)).cache_meta(4, 64))
    assert list(mc) == list(rc)
    for k, t in rc.items():
        assert (mc[k].shape, mc[k].dtype, mc[k].axes) == (t.shape, t.dtype,
                                                          tuple(t.axes)), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_batch_specs_are_the_references(arch, mesh):
    """``param_specs``, ``param_shardings``, ``train_state_shardings``
    and ``batch_shardings`` of the four assigned shapes, under every
    rules variant (the reference's ``REF_ONLY`` ones against the port's
    defaults)."""
    shape, names = MESHES[mesh]
    ref_mesh, my_mesh = AbstractMesh(shape, names), MeshShape(shape, names)
    for v in VARIANTS + REF_ONLY:
        ref = RefModel(ref_get(arch), RefOptions(**v))
        mine = Model(get(arch), RunOptions(**({} if v in REF_ONLY else v)))
        what = (arch, mesh, v)
        _same_specs(mine.param_specs(my_mesh), ref.param_specs(ref_mesh),
                    what)
        sh = mine.param_shardings(my_mesh)
        assert all(p.mesh is my_mesh for p in _flat(sh).values())
        _same_specs(sh, ref.param_shardings(ref_mesh), what)
        _same_specs(S.train_state_shardings(mine, my_mesh),
                    RS.train_state_shardings(ref, ref_mesh), what)
        for name, sp in SHAPES.items():
            _same_specs(mine.batch_shardings(sp, my_mesh),
                        ref.batch_shardings(REF_SHAPES[name], ref_mesh),
                        what + (name,))


def test_production_layouts():
    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16),
                                     ("pod", "data", "model"))):
        m = production_shape(multi_pod=multi_pod)
        assert m.axis_names == names and m.devices.shape == shape
        assert m.shape == dict(zip(names, shape)) and m.size == np.prod(shape)
        np.testing.assert_array_equal(m.devices,
                                      np.arange(m.size).reshape(shape))
        assert m.coords(37) == dict(zip(names, np.unravel_index(37, shape)))


def test_spec_for_drops_what_does_not_divide():
    """The reference's cases (``tests/test_sharding_hlo.py``) on a (2, 4)
    mesh, and the non-strict resolution, which keeps them."""
    mesh = MeshShape((2, 4), ("data", "model"))
    ref_mesh = AbstractMesh((2, 4), ("data", "model"))
    for shape, axes, want in (((16, 8), ("fsdp", "tensor"),
                               ("data", "model")),
                              ((92553, 16), ("vocab", "fsdp"),
                               (None, "data")),
                              ((4, 25, 64), (None, "tensor", None),
                               (None, None, None)),
                              ((6, 8), ("batch", None), ("data", None)),
                              ((), (), ())):
        got = SH.spec_for(shape, axes, mesh)
        assert got == want == RSH.spec_for(shape, axes, ref_mesh)
        assert type(got) is SH.Spec
    with SH.use_mesh(mesh, {"fsdp": ("pod", "data")}) as c:
        assert c.physical("fsdp") == ("data",) and SH.ctx() is c
        assert SH._resolve(("vocab", "fsdp"), (92553, 16)) == ("model",
                                                               "data")
    assert SH.ctx().mesh is None
    with SH.use_mesh(MeshShape((2, 2, 2), ("pod", "data", "model"))):
        assert SH._resolve(("batch",), (8,), strict=True) == (
            ("pod", "data"),)
        assert SH.Spec((("pod", "data"), "model")).axes() == (
            "pod", "data", "model")


def test_blocks_tile_the_leaf():
    """A rank's block is its place's slice; the blocks tile the leaf."""
    names = ("pod", "data", "model")
    layout = MeshShape((2, 2, 2), names)
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    spec = SH.Spec((("pod", "data"), "model", None))

    class At:           # a rank's view without a world
        def __init__(self, rank):
            self.shape, self.device = layout.shape, torch.device("cpu")
            self._at = layout.coords(rank)
        axis_size = MeshShape.axis_size

        def index(self, axes):
            i = 0
            for a in axes:
                i = i * self.shape[a] + self._at[a]
            return i
    blocks = [SH.shard_tensor(x, spec, At(r)) for r in range(8)]
    for r, b in enumerate(blocks):
        c = layout.coords(r)
        i = c["pod"] * 2 + c["data"]
        assert torch.equal(b, x[2 * i:2 * i + 2, 3 * c["model"]:
                                3 * c["model"] + 3])
        assert b.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()


def test_abstract_train_state_on_meta():
    for arch in ("llama3-8b", "whisper-large-v3", "mixtral-8x7b"):
        mine = _flat(S.abstract_train_state(Model(get(arch))))
        theirs = _flat(RS.abstract_train_state(RefModel(ref_get(arch))))
        assert list(mine) == list(theirs)
        for k, t in theirs.items():
            assert mine[k].device.type == "meta", k
            assert tuple(mine[k].shape) == tuple(t.shape), k
            assert str(mine[k].dtype).split(".")[-1] == str(t.dtype), k
    n = sum(t.numel() for t in _flat(Model(get("llama3-8b"))
                                     .abstract_params()).values())
    assert 8.0e9 < n < 8.1e9            # llama3-8b's 8.03B parameters
    spec = Model(get("qwen1.5-0.5b")).input_specs(SHAPES["train_4k"])
    assert spec["batch"]["tokens"].shape == (256, 4096)
    assert spec["batch"]["tokens"].device.type == "meta"


def test_mesh_helpers_and_their_errors():
    m = E.make_mesh_from(list(range(8)), model_axis=2, pod_axis=2)
    assert m.axis_names == ("pod", "data", "model")
    np.testing.assert_array_equal(m.devices, np.arange(8).reshape(2, 2, 2))
    m = E.make_mesh_from([0, 1, 2, 3, 4, 5], model_axis=2)
    assert m.shape == {"data": 3, "model": 2}
    for ranks, model in ((list(range(5)), 2), (list(range(6)), 4)):
        with pytest.raises(ValueError) as mine:
            E.make_mesh_from(ranks, model_axis=model)
        with pytest.raises(ValueError) as theirs:
            RE.make_mesh_from(ranks, model_axis=model)
        assert str(mine.value) == str(theirs.value)
    old = MeshShape((4, 2), ("data", "model"))
    new = E.shrink_mesh(old, [0, 1, 2, 3, 5])
    assert new.shape == {"data": 2, "model": 2}
    np.testing.assert_array_equal(new.devices, [[0, 1], [2, 3]])
    with pytest.raises(RuntimeError) as mine:
        E.shrink_mesh(old, [3])
    with pytest.raises(RuntimeError) as theirs:
        RE.shrink_mesh(AbstractMesh((4, 2), ("data", "model")), [3])
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="axis names"):
        MeshShape((2, 2), ("data",))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        MeshShape((2, 2), ("data", "model"), [0, 1, 2])
