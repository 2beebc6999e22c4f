"""Task prestart hooks: artifacts and templates.

Reference: client/allocrunner/taskrunner/artifact_hook.go (go-getter
fetch into the task dir) and template_hook.go (consul-template render).
Artifact sources: local paths, file:// and http(s):// URLs. Template
sources: embedded content or a file, rendered with the same ${...}
interpolation the driver config gets (client/taskenv).
"""

from __future__ import annotations

import os
import shutil
import urllib.request
from typing import Dict

from .taskenv import interpolate


class HookError(Exception):
    pass


def fetch_artifacts(task, task_dir: str, env: Dict[str, str],
                    node=None) -> None:
    """artifact_hook.go Prestart: each artifact lands under the task
    dir (relative_dest defaults to local/)."""
    for art in task.artifacts or []:
        source = interpolate(art.getter_source, env, node)
        rel = art.relative_dest or "local/"
        dest_dir = os.path.join(task_dir, rel)
        os.makedirs(dest_dir, exist_ok=True)
        name = os.path.basename(source.split("?")[0]) or "artifact"
        dest = os.path.join(dest_dir, name)
        try:
            if source.startswith(("http://", "https://")):
                with urllib.request.urlopen(source, timeout=30) as r, \
                        open(dest, "wb") as f:
                    shutil.copyfileobj(r, f)
            else:
                path = source[len("file://"):] \
                    if source.startswith("file://") else source
                if os.path.isdir(path):
                    shutil.copytree(path, dest, dirs_exist_ok=True)
                else:
                    shutil.copy(path, dest)
        except Exception as e:
            raise HookError(
                f"failed to fetch artifact {source!r}: {e}") from e
        mode = art.getter_options.get("mode") if art.getter_options else None
        if mode:
            try:
                os.chmod(dest, int(str(mode), 8))
            except (ValueError, OSError):
                pass


def render_templates(task, task_dir: str, env: Dict[str, str],
                     node=None) -> None:
    """template_hook.go Prestart: render embedded or file templates
    with env/node interpolation into the task dir."""
    for tmpl in task.templates or []:
        if tmpl.embedded_tmpl:
            content = tmpl.embedded_tmpl
        elif tmpl.source_path:
            src = interpolate(tmpl.source_path, env, node)
            try:
                with open(src) as f:
                    content = f.read()
            except OSError as e:
                raise HookError(
                    f"failed to read template {src!r}: {e}") from e
        else:
            continue
        rendered = interpolate(content, env, node)
        dest = tmpl.dest_path or "local/template"
        path = os.path.join(task_dir, dest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(rendered)
