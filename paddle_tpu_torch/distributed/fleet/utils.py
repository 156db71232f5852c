"""Fleet utils: filesystem abstraction — twin of
``paddle_tpu/distributed/fleet/utils.py`` (reference: fleet/utils/fs.py —
LocalFS, HDFSClient shell-out; host code, the same)."""
from __future__ import annotations

import os
import shutil
import subprocess


class LocalFS:
    def ls_dir(self, path):
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name)) else files).append(name)
        return dirs, files

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst):
        os.rename(src, dst)

    def upload(self, local, remote):
        shutil.copy(local, remote)

    def download(self, remote, local):
        shutil.copy(remote, local)

    def touch(self, path, exist_ok=True):
        open(path, "a").close()

    def mv(self, src, dst, overwrite=False):
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        os.rename(src, dst)

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient:
    """Shell-out hadoop client (reference framework/io/fs.cc + fs.py)."""

    def __init__(self, hadoop_home=None, configs=None):
        self._base = [os.path.join(hadoop_home, "bin/hadoop") if hadoop_home
                      else "hadoop", "fs"]
        self._configs = configs or {}

    def _run(self, *args):
        cmd = list(self._base)
        for k, v in self._configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        out = subprocess.run(cmd, capture_output=True, text=True)
        return out.returncode, out.stdout

    def is_exist(self, path):
        code, _ = self._run("-test", "-e", path)
        return code == 0

    def ls_dir(self, path):
        _, out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            (dirs if parts[0].startswith("d") else files).append(parts[-1])
        return dirs, files

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", path)

    def upload(self, local, remote):
        self._run("-put", local, remote)

    def download(self, remote, local):
        self._run("-get", remote, local)
