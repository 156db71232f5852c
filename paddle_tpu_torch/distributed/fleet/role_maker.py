"""Role makers — twin of ``paddle_tpu/distributed/fleet/role_maker.py``
(reference: fleet/base/role_maker.py:33 Gloo rendezvous, :528
PaddleCloudRoleMaker).

The rendezvous is ``distributed/env.py``'s (``torch.distributed`` and the
host backend of ``gloo.py``); the role maker only parses the env
contract (PADDLE_TRAINER_* / PADDLE_PSERVERS_* / TRAINING_ROLE) and
answers identity questions.
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._is_collective = False

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        return 0

    def server_index(self):
        return 0

    def worker_num(self):
        return 1

    def server_num(self):
        return 0

    def role_id(self):
        return self.worker_index()

    def get_trainer_endpoints(self):
        return []

    def get_pserver_endpoints(self):
        return []


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._worker_index = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        pse = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = pse.split(",") if pse else []
        self._role = (Role.SERVER
                      if os.environ.get("TRAINING_ROLE", "TRAINER") == "PSERVER"
                      else Role.WORKER)

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def worker_index(self):
        return self._worker_index

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)

    def server_index(self):
        return int(os.environ.get("PADDLE_PSERVER_ID", "0"))

    def get_trainer_endpoints(self):
        return self._trainer_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def _generate_role(self):
        return self._role


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        super().__init__(is_collective)
        self._worker_index = kwargs.get("current_id", self._worker_index)
        self._worker_num = kwargs.get("worker_num", self._worker_num)
        self._server_endpoints = kwargs.get("server_endpoints",
                                            self._server_endpoints)
