"""Per-allocation directory tree (reference: client/allocdir — shared
alloc dir + per-task local/secrets/tmp dirs, log dir under the shared
alloc dir; SharedAllocName/TaskLocal layout).
"""

from __future__ import annotations

import os
import shutil
import stat
import tempfile
from typing import Dict, Tuple


class AllocDir:
    def __init__(self, base_dir: str, alloc_id: str):
        if not base_dir:
            base_dir = os.path.join(tempfile.gettempdir(),
                                    "nomad-tpu-allocs")
        self.base = os.path.join(base_dir, alloc_id)
        self.shared = os.path.join(self.base, "alloc")
        self.logs = os.path.join(self.shared, "logs")
        self._task_dirs: Dict[str, str] = {}

    def build(self, task_names) -> None:
        os.makedirs(self.logs, exist_ok=True)
        os.makedirs(os.path.join(self.shared, "data"), exist_ok=True)
        os.makedirs(os.path.join(self.shared, "tmp"), exist_ok=True)
        for name in task_names:
            td = os.path.join(self.base, name)
            for sub in ("local", "secrets", "tmp"):
                os.makedirs(os.path.join(td, sub), exist_ok=True)
            # secrets dir is owner-only (allocdir secretsDirPerms)
            os.chmod(os.path.join(td, "secrets"),
                     stat.S_IRWXU)
            self._task_dirs[name] = td

    def task_dir(self, task: str) -> str:
        return self._task_dirs.get(task) or os.path.join(self.base, task)

    def task_paths(self, task: str) -> Tuple[str, str, str]:
        """(task_dir, local_dir, secrets_dir)."""
        td = self.task_dir(task)
        return td, os.path.join(td, "local"), os.path.join(td, "secrets")

    def destroy(self) -> None:
        shutil.rmtree(self.base, ignore_errors=True)
