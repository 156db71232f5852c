"""Fault G2: the mesh's device entry points never run on the CPU unless
the caller names it.

``paddle_tpu_torch.distributed`` ``devices()``, ``init_mesh(axes)`` and
``get_mesh()`` used to map ``device_type=None`` to the CPU when no card
was present and carry on there, while every other entry point of the port
raises (``paddle_tpu_torch.resolve_device``).  The reference,
``paddle_tpu/distributed/mesh.py``, builds its mesh over ``jax.devices()``
and never picks a device the caller did not name.  ``None`` now means the
CUDA cards and raises without one; ``"cpu"`` keeps the CPU.  The card's
absence is simulated, so the file checks the same on any machine."""
import pytest
import torch

from paddle_tpu_torch.distributed import (devices, force_device_count,
                                          get_mesh, init_mesh)
from paddle_tpu_torch.distributed import mesh as mesh_lib


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh_lib, "_GLOBAL_MESH", None)
    prev = force_device_count(None)
    yield
    force_device_count(prev)


@pytest.mark.parametrize("call", [
    lambda: devices(), lambda: devices("cuda"),
    lambda: init_mesh({"tp": 1}), lambda: init_mesh({"tp": 1}, None, "cuda"),
    lambda: get_mesh()],
    ids=["devices", "devices-cuda", "init_mesh", "init_mesh-cuda",
         "get_mesh"])
def test_no_card_raises_instead_of_running_on_the_cpu(no_card, call):
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    assert mesh_lib._GLOBAL_MESH is None


def test_the_cpu_when_named_is_unchanged(no_card):
    assert devices("cpu") == [torch.device("cpu")]
    mesh = init_mesh({"tp": 1}, device_type="cpu")
    assert mesh.slots == [torch.device("cpu")]
    assert get_mesh() is mesh
    force_device_count(2)
    assert devices("cpu") == [torch.device("cpu")] * 2
    assert init_mesh({"tp": 2}, device_type="cpu").shape == {"tp": 2}


def test_explicit_devices_need_no_lookup(no_card):
    mesh = init_mesh({"sp": 2}, devices=[torch.device("cpu")] * 2)
    assert mesh.slot(sp=1) == torch.device("cpu")
