"""Synchronous pub/sub event bus (a copy of
`aura_snn_rag_tpu/zones/events.py`, which imports no JAX; the port keeps
its own so it imports nothing of the JAX package).

Typed events (`brain_created`, `brain_stats_updated`, `neuron_fired`,
`content_processed`, `background_activity`), subscribe/unsubscribe, and a
publish that logs a handler's exception instead of raising it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

logger = logging.getLogger(__name__)

EVENT_TYPES = (
    "brain_created",
    "brain_stats_updated",
    "neuron_fired",
    "content_processed",
    "background_activity",
)


@dataclass
class Event:
    type: str
    data: Dict[str, Any] = field(default_factory=dict)
    source: str = ""


class EventBus:
    def __init__(self):
        self._subscribers: Dict[str, List[Callable[[Event], None]]] = {}
        self.published_count = 0
        self.error_count = 0

    def subscribe(self, event_type: str,
                  handler: Callable[[Event], None]) -> None:
        self._subscribers.setdefault(event_type, []).append(handler)

    def unsubscribe(self, event_type: str,
                    handler: Callable[[Event], None]) -> None:
        if event_type in self._subscribers:
            try:
                self._subscribers[event_type].remove(handler)
            except ValueError:
                pass

    def publish(self, event: Event) -> None:
        """Deliver synchronously; handler exceptions are logged, not raised."""
        self.published_count += 1
        for handler in self._subscribers.get(event.type, []):
            # a failing handler must not stop the publisher
            try:
                handler(event)
            except Exception as e:  # noqa: BLE001
                self.error_count += 1
                logger.warning("event handler failed for %s: %s",
                               event.type, e)

    def emit(self, event_type: str, source: str = "", **data) -> None:
        self.publish(Event(event_type, data, source))
