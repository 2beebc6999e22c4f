"""Plugin process entry: `python -m nomad_tpu_torch.plugins.launcher <driver>`
or `... --device <device-plugin>` (the re-exec'd plugin binary pattern
of go-plugin / `nomad logmon`)."""

import sys

from ..client.drivers import DRIVER_CATALOG
from .base import serve_plugin


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--device":
        from .device_client import (DEVICE_PLUGIN_CATALOG,
                                    build_device_methods)
        if args[1] not in DEVICE_PLUGIN_CATALOG:
            print(f"usage: launcher --device "
                  f"<{'|'.join(DEVICE_PLUGIN_CATALOG)}>",
                  file=sys.stderr)
            return 1
        plugin = DEVICE_PLUGIN_CATALOG[args[1]]()
        serve_plugin(plugin, methods=build_device_methods(plugin))
        return 0
    if len(args) != 1 or args[0] not in DRIVER_CATALOG:
        print(f"usage: launcher <{'|'.join(DRIVER_CATALOG)}> | "
              f"--device <plugin>", file=sys.stderr)
        return 1
    serve_plugin(DRIVER_CATALOG[args[0]]())
    return 0


if __name__ == "__main__":
    sys.exit(main())
