"""Plugins behind the process boundary: driver plugins (driver_client),
the CUDA device plugin (device_client), their launcher and handshake
(base, launcher), config specs (hclspec), and the device attribute
structures the placement path compares (psstructs)."""

from .base import HANDSHAKE_COOKIE_KEY, HANDSHAKE_COOKIE_VALUE, serve_plugin
from .driver_client import ExternalDriver

__all__ = ["HANDSHAKE_COOKIE_KEY", "HANDSHAKE_COOKIE_VALUE",
           "serve_plugin", "ExternalDriver"]
