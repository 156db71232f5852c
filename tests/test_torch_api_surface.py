"""The public surface of ``paddle_tpu_torch`` against the JAX package's
``API.spec``: every ``paddle_tpu.<name>`` it lists is resolved under
``paddle_tpu_torch`` by importing the longest importable module prefix
and ``getattr``-ing the rest.

Held whole (every name outside the two lists below resolves): the
top-level namespace with the classes it exports (``CPUPlace``,
``ParamAttr``, ``Model``, ...), ``Tensor`` and its aliases ``VarBase``
and ``LoDTensor``, ``text``'s models and generation, ``vision``'s four
re-exports and ``autograd``'s ``grad`` / ``backward``.  The total count
of resolved names may not fall below ``RESOLVED_FLOOR``, the count this
test was written at, so no later change can drop a name.

``WAITING`` names what waits, with its ROADMAP item; ``LEAKED_HELPERS``
the JAX package's internal helpers that its ``import *`` and its
``_patch_tensor_methods`` leak into the namespaces (at most 11)."""
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RESOLVED_FLOOR = 2230

WAITING = {
    # item 11: distributed training
    "DataParallel": "item 11",
    # item 13: the static graph, dy2static and the fluid arrays
    **{n: "item 13" for n in (
        "data", "to_static", "enable_static", "disable_static",
        "enable_dygraph", "disable_dygraph", "in_dygraph_mode",
        "in_dynamic_mode", "create_global_var", "create_array",
        "array_read", "array_write", "array_length")},
    # item 13: the text datasets, vision's image backend, transforms, ops
    **{f"text.{n}": "item 13" for n in (
        "Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14",
        "WMT16")},
    "vision.image_load": "item 13", "vision.get_image_backend": "item 13",
    "vision.set_image_backend": "item 13", "vision.ops": "item 13",
    "vision.transforms": "item 13",
    # step E2: the tape's own objects and SelectedRows
    "get_tensor_from_selected_rows": "step E2",
    "autograd.GradNode": "step E2", "autograd.run_backward": "step E2",
}

LEAKED_HELPERS = {
    "apply": "ops.dispatch's dispatcher, imported by the op modules",
    "flag_value": "framework.flags' reader, imported by math and linalg",
    "norm_axis": "an argument normalizer of ops/_helpers.py",
    "norm_shape": "an argument normalizer of ops/_helpers.py",
    "to_tensor_like": "an argument normalizer of ops/_helpers.py",
    "value_of": "an argument normalizer of ops/_helpers.py",
    "resolve_dtype": "an argument normalizer of ops/_helpers.py",
    "next_rng_key": "the JAX key stream of framework/random.py",
    "builtins_sum": "manipulation.py's copy of the builtin sum",
    "slice_builtin": "manipulation.py's alias of the builtin slice",
    "jax_topk": "search.py's wrapper of jax.lax.top_k",
}

TENSORS = ("Tensor", "VarBase", "LoDTensor")
VISION = ("LeNet", "ResNet", "resnet18", "resnet50")


def _spec_names():
    names = set()
    with open(os.path.join(ROOT, "API.spec")) as f:
        for line in f:
            if line.strip():
                names.add(line.split(" ", 1)[0][len("paddle_tpu."):])
    return sorted(names)


def _resolves(rel):
    parts = ["paddle_tpu_torch"] + rel.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except Exception:
            continue
        for p in parts[i:]:
            if not hasattr(obj, p):
                return False
            obj = getattr(obj, p)
        return True
    return False


@pytest.fixture(scope="module")
def spec():
    import paddle_tpu_torch  # noqa: F401

    return {n: _resolves(n) for n in _spec_names()}


def _namespace(name):
    """The held namespace a spec name belongs to, or None."""
    head, _, rest = name.partition(".")
    top = importlib.import_module("paddle_tpu_torch")
    if head in TENSORS:
        return head
    if head == "text":
        return "text"
    if head == "vision":
        return "vision" if rest.split(".")[0] in VISION else None
    if head == "autograd":
        return "autograd" if rest in ("grad", "backward") else None
    if not rest:
        return "top"
    attr = getattr(top, head, None)
    if attr is not None and isinstance(attr, type):
        return "top"
    return "top" if head in WAITING else None


def _excused(name):
    head, _, rest = name.partition(".")
    leaf = rest if head in TENSORS else name
    if leaf in LEAKED_HELPERS:
        return True
    return any(name == w or name.startswith(w + ".") for w in WAITING)


@pytest.mark.parametrize("ns", ["top", "Tensor", "VarBase", "LoDTensor",
                                "text", "vision", "autograd"])
def test_namespace_resolves_every_name(spec, ns):
    names = [n for n in spec if _namespace(n) == ns]
    assert names, ns
    missing = [n for n in names if not spec[n] and not _excused(n)]
    assert not missing, f"{ns}: {len(missing)} unresolved: {missing[:20]}"


def test_vision_waiting_names_are_the_rest_of_vision(spec):
    rest = [n for n in spec if n.startswith("vision.") and not spec[n]]
    assert rest and all(_excused(n) for n in rest), rest


def test_the_lists_name_spec_entries(spec):
    assert len(LEAKED_HELPERS) <= 11
    for name in list(WAITING) + list(LEAKED_HELPERS):
        assert any(n == name or n.startswith(name + ".") for n in spec), name
    # the helpers stay internal in the port
    for name in LEAKED_HELPERS:
        for entry in (name, f"Tensor.{name}"):
            assert not spec.get(entry, False), entry


def test_resolved_count_does_not_fall(spec):
    n = sum(spec.values())
    assert n >= RESOLVED_FLOOR, f"{n} of {len(spec)} resolve"
