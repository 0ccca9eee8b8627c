"""Process-local event bus replacing the reference's DOM event dispatch.

The reference communicates through three document-level events
(headtrackrStatus src/main.js:70-77, facetrackingEvent src/facetrackr.js:112-125,
headtrackingEvent src/headposition.js:183-188).  Here the same three event types
flow through an in-process bus with the same payload field names.

A module-level default bus mirrors the single global ``document``; Tracker
instances can be given private buses for multi-session isolation.  The port's
copy of headtrackr_tpu/runtime/events.py (the same types and constants; it
imports nothing of the JAX package).
"""

import threading

__all__ = ["Event", "EventBus", "default_bus", "add_event_listener",
           "remove_event_listener", "dispatch_event",
           "FACETRACKING", "HEADTRACKING", "STATUS"]

FACETRACKING = "facetrackingEvent"
HEADTRACKING = "headtrackingEvent"
STATUS = "headtrackrStatus"


class Event:
    """A dispatched event: ``type`` plus payload fields as attributes."""

    def __init__(self, type_, payload=None):
        self.type = type_
        if payload:
            self.__dict__.update(payload)

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items() if k != "type"}
        return f"Event({self.type!r}, {fields})"


class EventBus:
    """Listener lists are copy-on-write tuples: mutation takes the lock and
    swaps in a new tuple, so the dispatch hot path (hundreds of calls per
    serving tick) reads lock-free."""

    def __init__(self):
        self._listeners = {}  # type -> tuple of callbacks (copy-on-write)
        self._lock = threading.Lock()

    def add_event_listener(self, type_, callback):
        with self._lock:
            self._listeners[type_] = \
                self._listeners.get(type_, ()) + (callback,)
        return callback

    def remove_event_listener(self, type_, callback):
        with self._lock:
            cur = list(self._listeners.get(type_, ()))
            try:
                cur.remove(callback)
                self._listeners[type_] = tuple(cur)
            except ValueError:
                pass

    def dispatch_event(self, type_, payload=None):
        ev = payload if isinstance(payload, Event) else Event(type_, payload)
        for cb in self._listeners.get(type_, ()):  # atomic dict read, COW
            cb(ev)
        return ev

    def clear(self):
        with self._lock:
            self._listeners.clear()


default_bus = EventBus()


def add_event_listener(type_, callback):
    return default_bus.add_event_listener(type_, callback)


def remove_event_listener(type_, callback):
    default_bus.remove_event_listener(type_, callback)


def dispatch_event(type_, payload=None):
    return default_bus.dispatch_event(type_, payload)
