"""The runtime: batched multi-stream serving, the session Tracker, events,
frame sources, fanout and checkpoints."""
