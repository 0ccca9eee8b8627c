"""Status message UI (spec: src/ui.js).

The reference injects an overlay <div> showing human-readable status messages
with a 3 s auto-clear.  Here, Ui subscribes to headtrackrStatus on an event bus
and maintains ``message`` (optionally echoing to stdout); the message tables
are verbatim from src/ui.js:38-50.  The port's copy of
headtrackr_tpu/runtime/ui.py.
"""

import threading

from . import events as ev

__all__ = ["Ui", "SUPPORT_MESSAGES", "STATUS_MESSAGES"]

SUPPORT_MESSAGES = {
    "no getUserMedia": "getUserMedia is not supported in your browser :(",
    "no camera": "no camera found :(",
}

STATUS_MESSAGES = {
    "whitebalance": "Waiting for camera whitebalancing",
    "detecting": "Please wait while camera is detecting your face...",
    "hints": ("We seem to have some problems detecting your face. Please make "
              "sure that your face is well and evenly lighted, and that your "
              "camera is working."),
    "redetecting": "Lost track of face, trying to detect again..",
    "lost": "Lost track of face :(",
    "found": "Face found! Move your head!",
}

FADE_SECONDS = 3.0  # src/ui.js:61


class Ui:
    def __init__(self, bus=None, echo=False, auto_fade=True):
        # auto_fade defaults ON for reference parity: the overlay always
        # clears 3 s after the last message (src/ui.js:61-69).  Pass False
        # for a sticky message (deterministic assertions in tests/tools).
        self._bus = bus or ev.default_bus
        self.echo = echo
        self.auto_fade = auto_fade
        self.message = ""
        self._override = False
        self._timer = None
        self._listener = self._bus.add_event_listener(ev.STATUS, self._on_status)

    def _on_status(self, event):
        status = getattr(event, "status", None)
        if status in STATUS_MESSAGES:
            if not self._override:
                self._set(STATUS_MESSAGES[status])
        elif status in SUPPORT_MESSAGES:
            self._override = True
            self._set(SUPPORT_MESSAGES[status])

    def _set(self, message):
        self.message = message
        if self.echo:
            print(f"[headtrackr] {message}")
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self.auto_fade:
            self._timer = threading.Timer(FADE_SECONDS, self._clear)
            self._timer.daemon = True
            self._timer.start()

    def _clear(self):
        self.message = ""
        self._override = False

    def close(self):
        self._bus.remove_event_listener(ev.STATUS, self._on_status)
        if self._timer is not None:
            self._timer.cancel()
