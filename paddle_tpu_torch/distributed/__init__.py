"""Distributed execution — so far the single-controller device mesh the
mesh-sharded serving replica runs on (``distributed/mesh.py``)."""
from .mesh import (Mesh, all_gather, devices, force_device_count, get_mesh,
                   init_mesh, pmax, psum)

__all__ = ["Mesh", "devices", "force_device_count", "init_mesh", "get_mesh",
           "pmax", "psum", "all_gather"]
