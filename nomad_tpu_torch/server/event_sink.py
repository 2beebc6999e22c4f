"""The event-sink record the state store holds and a snapshot carries
(reference: nomad/stream/sink.go).

The sink manager and the webhook delivery beside it in the JAX package's
server/event_sink.py are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

SINK_WEBHOOK = "webhook"


@dataclass
class EventSink:
    """structs.EventSink (nomad/stream/sink.go)."""
    id: str = ""
    type: str = SINK_WEBHOOK
    address: str = ""               # webhook URL
    # topic -> keys filter, same shape the broker's subscriptions use
    topics: Dict[str, List[str]] = field(default_factory=dict)
    latest_index: int = 0           # committed delivery progress
    create_index: int = 0
    modify_index: int = 0

    def stub(self) -> Dict:
        return {"ID": self.id, "Type": self.type, "Address": self.address,
                "Topics": dict(self.topics),
                "LatestIndex": self.latest_index,
                "CreateIndex": self.create_index,
                "ModifyIndex": self.modify_index}
