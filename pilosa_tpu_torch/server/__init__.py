"""The HTTP edge of a standalone node: ``ServerNode`` wires ``Holder`` ->
``Executor`` -> ``API`` -> ``HTTPServer`` with admission control, deadlines
and query profiles (the port's counterpart of pilosa_tpu/server/)."""

from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.httpd import HTTPServer
from pilosa_tpu_torch.server.node import ServerNode

__all__ = ["API", "HTTPServer", "ServerNode"]
