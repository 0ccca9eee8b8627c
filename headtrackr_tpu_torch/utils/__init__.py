"""Host-side helpers (debug rendering)."""
