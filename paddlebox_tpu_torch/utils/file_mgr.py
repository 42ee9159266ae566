"""File manager: the local file system and a shell-backed remote one.

Counterpart of paddlebox_tpu/utils/file_mgr.py (boxps::PaddleFileMgr, the
pybind BoxFileMgr, box_wrapper.h:710-732, 1005-1030): list, download,
upload, remove, rename, touch, mkdir and file size. ``LocalFileMgr`` works
on the local file system; ``ShellFileMgr`` runs a command prefix with the
hadoop-fs verbs (e.g. ``hadoop fs``). Plain host code: nothing in the
trainer calls it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List


class LocalFileMgr:
    def list_dir(self, path: str) -> List[str]:
        return sorted(os.path.join(path, f) for f in os.listdir(path))

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def download(self, remote: str, local: str) -> None:
        shutil.copyfile(remote, local)

    def upload(self, local: str, remote: str) -> None:
        os.makedirs(os.path.dirname(remote) or ".", exist_ok=True)
        shutil.copyfile(local, remote)

    def remove(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def touch(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        open(path, "a").close()

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def file_size(self, path: str) -> int:
        return os.path.getsize(path)


class ShellFileMgr:
    """Remote FS through a shell command prefix with hadoop-fs verb shape:
    `<prefix> -ls|-test -e|-get|-put|-rm|-mv|-touchz|-mkdir|-du <args>`."""

    def __init__(self, cmd_prefix: str) -> None:
        self.cmd_prefix = cmd_prefix

    def _run(self, args: str, check: bool = True) -> str:
        proc = subprocess.run("%s %s" % (self.cmd_prefix, args), shell=True,
                              capture_output=True, text=True)
        if check and proc.returncode != 0:
            raise IOError("file mgr command failed: %s %s\n%s"
                          % (self.cmd_prefix, args, proc.stderr))
        return proc.stdout

    def list_dir(self, path: str) -> List[str]:
        out = self._run("-ls %s" % path)
        files = []
        for line in out.splitlines():
            parts = line.split()
            if parts and "/" in parts[-1]:
                files.append(parts[-1])
        return sorted(files)

    def exists(self, path: str) -> bool:
        proc = subprocess.run("%s -test -e %s" % (self.cmd_prefix, path),
                              shell=True, capture_output=True)
        return proc.returncode == 0

    def download(self, remote: str, local: str) -> None:
        self._run("-get %s %s" % (remote, local))

    def upload(self, local: str, remote: str) -> None:
        self._run("-put %s %s" % (local, remote))

    def remove(self, path: str) -> None:
        self._run("-rm -r %s" % path, check=False)

    def rename(self, src: str, dst: str) -> None:
        self._run("-mv %s %s" % (src, dst))

    def touch(self, path: str) -> None:
        self._run("-touchz %s" % path)

    def mkdir(self, path: str) -> None:
        self._run("-mkdir -p %s" % path)

    def file_size(self, path: str) -> int:
        out = self._run("-du %s" % path)
        first = out.split()
        return int(first[0]) if first else 0


def make_file_mgr(uri_or_cmd: str = ""):
    """'' → local FS; anything else is treated as the remote shell command
    prefix (e.g. 'hadoop fs -D fs.default.name=afs://...')."""
    return ShellFileMgr(uri_or_cmd) if uri_or_cmd else LocalFileMgr()
