"""Process / cluster environment — twin of ``paddle_tpu/distributed/env.py``.

Reference analog: the PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS env
contract (fleet/launch_utils.py:57) + the TCP bootstrap of the
communicators (gen_comm_id_helper.cc:286).  Where the JAX package calls
``jax.distributed.initialize``, the port calls
``torch.distributed.init_process_group`` with the first endpoint as the
rendezvous (``tcp://host:port``): NCCL between cards, gloo on the CPU.
``PADDLE_DIST_BACKEND=gloo`` keeps to the host backend of
``distributed/gloo.py`` alone, which ``PADDLE_GLOO_ENDPOINT`` starts
whenever it is set.  Within a process the devices are the mesh's slots
(``distributed/mesh.py``); ranks are processes.
"""
from __future__ import annotations

import os

import torch

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "device_count",
           "ParallelEnv"]

_initialized = False


def _torch_backend(choice: str) -> str:
    """``auto``: NCCL with a card, torch's gloo without; else as named."""
    if choice == "auto":
        return "nccl" if torch.cuda.is_available() else "gloo"
    return choice


def init_parallel_env(strategy=None):
    """reference: paddle.distributed.init_parallel_env (parallel.py:57)."""
    global _initialized
    if _initialized:
        return
    trainers = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    backend = os.environ.get("PADDLE_DIST_BACKEND", "auto")
    if trainers > 1 and backend == "gloo" \
            and not os.environ.get("PADDLE_GLOO_ENDPOINT"):
        raise ValueError(
            "PADDLE_DIST_BACKEND=gloo requires PADDLE_GLOO_ENDPOINT "
            "(host:port of the rank-0 rendezvous)")
    if trainers > 1 and os.environ.get("PADDLE_GLOO_ENDPOINT"):
        # host-side eager collectives (the GlooWrapper analog)
        from . import gloo

        gloo.init_gloo(rank=trainer_id, world_size=trainers)
    if trainers > 1 and endpoints and backend != "gloo":
        coordinator = endpoints.split(",")[0]
        torch.distributed.init_process_group(
            backend=_torch_backend(backend),
            init_method=f"tcp://{coordinator}",
            world_size=trainers, rank=trainer_id)
    _initialized = True


def get_rank() -> int:
    if os.environ.get("PADDLE_TRAINER_ID") is not None:
        return int(os.environ["PADDLE_TRAINER_ID"])
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_world_size() -> int:
    if os.environ.get("PADDLE_TRAINERS_NUM") is not None:
        return int(os.environ["PADDLE_TRAINERS_NUM"])
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def device_count() -> int:
    """The mesh slots of this process: the cards, or on a machine without
    one the CPU's (``force_device_count`` sets how many)."""
    from .mesh import devices

    return len(devices("cuda" if torch.cuda.is_available() else "cpu"))


class ParallelEnv:
    """reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        sel = (os.environ.get("FLAGS_selected_gpus")
               or os.environ.get("FLAGS_selected_tpus", "0"))
        return int(sel.split(",")[0])

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    local_rank = rank
    nranks = world_size
