"""The benchmark's plain reference: a frozen copy of the port's NumPy oracle
(a transcription of auduno/headtrackr's JavaScript) with the serving rules
it lacks, and the per-stream driver that replays a stream's frames through
it (``serving``).  Imports numpy alone: nothing of the program, of JAX or of
the JAX package."""
