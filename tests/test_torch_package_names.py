"""The port's public names against the JAX package's: every ``__all__`` of
``xmtpu``, ``xmtpu.solver``, ``.ops``, ``.assembly``, ``.pipeline``, ``.io``
and ``.parallel`` is present in its ``xmtpu_torch`` counterpart, as the port's own
objects, and so is every public function and class of the modules ported
without an ``__all__``; the options dataclasses of the mapper's tail stages
carry every field and default of the reference's; and
``convert.options_from_reference`` carries them across by field name.
"""

import dataclasses
import importlib
import inspect

import pytest

PACKAGES = ["", ".solver", ".ops", ".assembly", ".pipeline", ".io",
            ".parallel"]
MODULES = [".config", ".utils.logging", ".utils.timer", ".pipeline.refine",
           ".pipeline.relpose_filter", ".pipeline.datasets",
           ".pipeline.depth", ".pipeline.depth_net",
           ".pipeline.synthetic_images", ".pipeline.features",
           ".pipeline.visualization", ".parallel.mesh",
           ".parallel.distributed", ".parallel._multihost_worker"]
# parameters a port function may add after the reference's: the device,
# and for the process group its backend (gloo for ranks sharing a card)
# and the mesh's slots a process
EXTRA_PARAMS = {".parallel.distributed": {"device", "backend", "slots"}}
OPTIONS = [("global_positioning", "PositionerOptions"),
           ("bundle_adjustment", "BundleAdjusterOptions"),
           ("triangulation", "TriangulatorOptions"),
           ("gravity", "GravityRefinerOptions"),
           ("global_mapper", "GlobalMapperOptions")]


@pytest.mark.parametrize("sub", PACKAGES)
def test_all_names_present(sub):
    ref = importlib.import_module("xmtpu" + sub)
    port = importlib.import_module("xmtpu_torch" + sub)
    missing = [n for n in ref.__all__ if n not in port.__all__]
    assert not missing, missing
    for name in ref.__all__:
        obj = getattr(port, name)
        mod = getattr(obj, "__module__", getattr(obj, "__name__", ""))
        if name != "__version__":
            assert mod.startswith("xmtpu_torch"), (name, mod)
    if not sub:
        assert port.__version__ == ref.__version__


@pytest.mark.parametrize("sub", MODULES)
def test_module_names_present(sub):
    """Every function and class the JAX module defines (public or private:
    the tests of both packages reach ``_expm_so3``, ``_to_input``) is
    defined by the port's module of the same path, with the same
    parameters first and in order (the port may add ``device``)."""
    ref = importlib.import_module("xmtpu" + sub)
    port = importlib.import_module("xmtpu_torch" + sub)
    names = [n for n, o in vars(ref).items()
             if (inspect.isfunction(o) or inspect.isclass(o))
             and o.__module__ == ref.__name__]
    assert names
    for n in names:
        obj = getattr(port, n, None)
        assert obj is not None and obj.__module__ == port.__name__, n
        if inspect.isfunction(obj):
            a = list(inspect.signature(getattr(ref, n)).parameters)
            b = list(inspect.signature(obj).parameters)
            extra = EXTRA_PARAMS.get(sub, {"device"})
            assert b[:len(a)] == a and set(b[len(a):]) <= extra, n


@pytest.mark.parametrize("module,name", OPTIONS)
def test_option_fields_and_defaults_match(module, name):
    ref = getattr(importlib.import_module(f"xmtpu.pipeline.{module}"), name)
    port = getattr(importlib.import_module(f"xmtpu_torch.pipeline.{module}"),
                   name)
    a, b = ref(), port()
    ref_fields = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == ref_fields
    for f in ref_fields:
        va, vb = getattr(a, f), getattr(b, f)
        if dataclasses.is_dataclass(va):
            assert dataclasses.asdict(vb) == dataclasses.asdict(va), f
        else:
            assert vb == va and type(vb) is type(va), f


@pytest.mark.parametrize("module,name", OPTIONS[:4])
def test_options_from_reference(module, name):
    from xmtpu_torch.convert import options_from_reference

    ref = getattr(importlib.import_module(f"xmtpu.pipeline.{module}"), name)
    port = getattr(importlib.import_module(f"xmtpu_torch.pipeline.{module}"),
                   name)
    changed = {}
    for f in dataclasses.fields(ref):
        v = getattr(ref(), f.name)
        changed[f.name] = (not v if isinstance(v, bool) else
                           v + 1 if isinstance(v, (int, float)) else v)
    x = ref(**changed)
    got = options_from_reference(x)
    assert type(got) is port
    assert dataclasses.asdict(got) == dataclasses.asdict(x)
    assert options_from_reference(dataclasses.asdict(x), kind=name) == got
    with pytest.raises(ValueError, match="no field"):
        options_from_reference({**dataclasses.asdict(x), "bogus": 1},
                               kind=name)
    with pytest.raises(ValueError, match="no port class"):
        options_from_reference({}, kind="MapperOptions")
