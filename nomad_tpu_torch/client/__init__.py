from .agent import Client, ClientConfig
from .drivers import MockDriver, ExecDriver, RawExecDriver, DRIVER_CATALOG
