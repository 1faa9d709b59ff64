"""Cluster node identity.

Reference: node.go (Node struct), uri.go (URI :80-216).

The port's copy of pilosa_tpu/cluster/node.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class URI:
    """Reference uri.go:80. scheme://host:port."""

    scheme: str = "http"
    host: str = "localhost"
    port: int = 10101

    def __str__(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    @classmethod
    def parse(cls, s: str) -> "URI":
        if "://" in s:
            scheme, rest = s.split("://", 1)
        else:
            scheme, rest = "http", s
        host, _, port = rest.partition(":")
        return cls(scheme=scheme, host=host or "localhost",
                   port=int(port) if port else 10101)


@dataclass
class Node:
    """Reference Node (node.go)."""

    id: str
    uri: URI = field(default_factory=URI)
    is_coordinator: bool = False
    state: str = "READY"

    def to_json(self) -> dict:
        return {"id": self.id, "uri": {"scheme": self.uri.scheme,
                                       "host": self.uri.host,
                                       "port": self.uri.port},
                "isCoordinator": self.is_coordinator}

    @classmethod
    def from_json(cls, d: dict) -> "Node":
        u = d.get("uri") or {}
        return cls(id=d["id"],
                   uri=URI(scheme=u.get("scheme", "http"),
                           host=u.get("host", "localhost"),
                           port=int(u.get("port", 10101))),
                   is_coordinator=d.get("isCoordinator", False))
